"""JAX parameter trees -> the port's state dict (reference checkpoint names).

The port's parameter names and layouts are those of the reference torch
checkpoint (``panaceaplus_40k_deepspeed.ckpt``), so that checkpoint loads
with no converter. This module carries weights the other way, from the JAX
package's flax trees, for the parity tests: its own copy of the UNet (with
its ``label_emb`` variants), ControlNet, VAE and CLIP parts of the key map
of ``panacea_tpu/utils/convert.py:29-360``, applied with the inverse layout
transforms and the CLIP q/k/v re-packing of ``:630-705``, of the
StreamPETR detector's (``:910-1178``), and of the metric towers'
(InceptionV3 and I3D, ``:766-903``). Where the JAX package has no torch
mapping (the legacy attention block, the VAE encoder's attention, the
temporal VAE blocks, the CLIP vision tower, ``DownSampler``), the flax names
are mapped to the reference's here alone.

  flax Dense (I, O)        -> torch Linear (O, I)
  flax Conv (kh, kw, I, O) -> torch Conv2d (O, I, kh, kw)
  flax (k, I, O)           -> torch Conv1d (O, I, k)
  flax (kt, kh, kw, I, O)  -> torch Conv3d (O, I, kt, kh, kw)
  LayerNorm/GroupNorm scale -> weight
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from panacea_tpu_torch.models.unet import plan_blocks

Path = Tuple[str, ...]
Entry = Tuple[Path, Callable[[np.ndarray], np.ndarray]]


def _none(w):
    return w


def _linear(w):
    return np.transpose(w)


def _conv1d(w):
    return np.transpose(w, (2, 1, 0))


def _conv2d(w):
    return np.transpose(w, (3, 2, 0, 1))


def _conv3d(w):
    return np.transpose(w, (4, 3, 0, 1, 2))


def _deconv2d(w):
    """flax ConvTranspose (kh, kw, I, O), a mirrored filter -> torch
    ConvTranspose2d (I, O, kh, kw): the inverse of JAX ``_t_deconv2d``."""
    return np.ascontiguousarray(np.transpose(w[::-1, ::-1], (2, 3, 0, 1)))


def _gn(ref: str, path: Path) -> Dict[str, Entry]:
    return {f"{ref}.weight": (path + ("GroupNorm_0", "scale"), _none),
            f"{ref}.bias": (path + ("GroupNorm_0", "bias"), _none)}


def _norm_flat(ref: str, path: Path) -> Dict[str, Entry]:
    """LayerNorm and TemporalGroupNorm: scale/bias directly under the path."""
    return {f"{ref}.weight": (path + ("scale",), _none),
            f"{ref}.bias": (path + ("bias",), _none)}


def _conv(ref: str, path: Path, t=_conv2d) -> Dict[str, Entry]:
    return {f"{ref}.weight": (path + ("kernel",), t),
            f"{ref}.bias": (path + ("bias",), _none)}


def _dense(ref: str, path: Path, bias: bool = True) -> Dict[str, Entry]:
    m = {f"{ref}.weight": (path + ("kernel",), _linear)}
    if bias:
        m[f"{ref}.bias"] = (path + ("bias",), _none)
    return m


def _attention(ref: str, path: Path) -> Dict[str, Entry]:
    m = {}
    for n in ("to_q", "to_k", "to_v"):
        m.update(_dense(f"{ref}.{n}", path + (n,), bias=False))
    m.update(_dense(f"{ref}.to_out.0", path + ("to_out",)))
    return m


def basic_block_map(ref: str, path: Path) -> Dict[str, Entry]:
    m = {}
    m.update(_attention(f"{ref}.attn1", path + ("attn1",)))
    m.update(_attention(f"{ref}.attn2", path + ("attn2",)))
    for n in ("norm1", "norm2", "norm3"):
        m.update(_norm_flat(f"{ref}.{n}", path + (n,)))
    m.update(_dense(f"{ref}.ff.net.0.proj", path + ("ff", "proj")))
    m.update(_dense(f"{ref}.ff.net.2", path + ("ff", "out")))
    return m


def st_transformer_map(ref: str, path: Path, depth: int = 1,
                       insert_crossview: bool = True) -> Dict[str, Entry]:
    m = {}
    for suffix in ("", "_temporal") + (("_crossview",) if insert_crossview else ()):
        m.update(_gn(f"{ref}.norm{suffix}", path + (f"norm{suffix}",)))
        m.update(_dense(f"{ref}.proj_in{suffix}", path + (f"proj_in{suffix}",)))
        m.update(_dense(f"{ref}.proj_out{suffix}", path + (f"proj_out{suffix}",)))
        for d in range(depth):
            m.update(basic_block_map(f"{ref}.transformer_blocks{suffix}.{d}",
                                     path + (f"blocks{suffix}_{d}",)))
    return m


def _temporal_conv(ref: str, path: Path) -> Dict[str, Entry]:
    return {f"{ref}.weight": (path + ("conv_kernel",), _conv1d),
            f"{ref}.bias": (path + ("conv_bias",), _none)}


def _conv1x1d(w):
    """flax Dense (I, O) -> torch Conv1d with k=1 (O, I, 1)."""
    return np.transpose(w)[:, :, None]


def legacy_attention_map(ref: str, path: Path) -> Dict[str, Entry]:
    """``LegacyAttentionBlock3D``: its norms and k=1 Conv1d projections,
    the dead ``qkv_temporal`` included."""
    m = {}
    for suffix in ("", "_temporal"):
        m.update(_gn(f"{ref}.norm{suffix}", path + (f"norm{suffix}",)))
        for n in ("qkv", "proj_out"):
            m[f"{ref}.{n}{suffix}.weight"] = (path + (f"{n}{suffix}", "kernel"), _conv1x1d)
            m[f"{ref}.{n}{suffix}.bias"] = (path + (f"{n}{suffix}", "bias"), _none)
    return m


def label_emb_map(prefix: str, path: Path, num_classes) -> Dict[str, Entry]:
    """The ``label_emb`` variants (panacea_tpu/utils/convert.py:178-201)."""
    if num_classes is None:
        return {}
    if num_classes == "continuous":
        return _dense(f"{prefix}.label_emb", path + ("label_emb",))
    if num_classes == "sequential":
        m = _dense(f"{prefix}.label_emb.0.0", path + ("label_emb_0",))
        m.update(_dense(f"{prefix}.label_emb.0.2", path + ("label_emb_2",)))
        return m
    return {f"{prefix}.label_emb.weight": (path + ("label_emb", "embedding"), _none)}


def resblock_map(ref: str, path: Path) -> Dict[str, Entry]:
    m = {}
    m.update(_gn(f"{ref}.in_layers.0", path + ("in_norm",)))
    m.update(_conv(f"{ref}.in_layers.2", path + ("in_conv",)))
    m.update(_norm_flat(f"{ref}.in_layers_temporal.0", path + ("in_norm_temporal",)))
    m.update(_temporal_conv(f"{ref}.in_layers_temporal.2", path + ("in_conv_temporal",)))
    m.update(_dense(f"{ref}.emb_layers.1", path + ("emb_proj",)))
    m.update(_gn(f"{ref}.out_layers.0", path + ("out_norm",)))
    m.update(_conv(f"{ref}.out_layers.3", path + ("out_conv",)))
    m.update(_norm_flat(f"{ref}.out_layers_temporal.0", path + ("out_norm_temporal",)))
    m.update(_temporal_conv(f"{ref}.out_layers_temporal.3", path + ("out_conv_temporal",)))
    m.update(_conv(f"{ref}.skip_connection", path + ("skip_conv",)))  # absent = identity
    return m


def unet_map(prefix: str, path: Path, model_channels: int, channel_mult,
             num_res_blocks: int, attention_resolutions, transformer_depth: int = 1,
             insert_crossview: bool = True, encoder_only: bool = False, num_classes=None,
             legacy: bool = False) -> Dict[str, Entry]:
    """``legacy``: ``LegacyAttentionBlock3D``s where the transformers would be
    (``use_spatial_transformer=False``)."""
    input_plan, output_plan, _ = plan_blocks(model_channels, tuple(channel_mult),
                                             num_res_blocks, tuple(attention_resolutions))

    def attn_map(ref, p):
        if legacy:
            return legacy_attention_map(ref, p)
        return st_transformer_map(ref, p, transformer_depth, insert_crossview)

    m = {}
    m.update(_dense(f"{prefix}.time_embed.0", path + ("time_embed", "dense0")))
    m.update(_dense(f"{prefix}.time_embed.2", path + ("time_embed", "dense1")))
    m.update(label_emb_map(prefix, path, num_classes))
    for bi, item in enumerate(input_plan):
        ref = f"{prefix}.input_blocks.{bi}"
        if item[0] == "conv":
            m.update(_conv(f"{ref}.0", path + (f"in_{bi}_conv",)))
        elif item[0] == "down":
            m.update(_conv(f"{ref}.0.op", path + (f"in_{bi}_down", "conv")))
        else:
            m.update(resblock_map(f"{ref}.0", path + (f"in_{bi}_res",)))
            if item[2]:
                m.update(attn_map(f"{ref}.1", path + (f"in_{bi}_attn",)))
    m.update(resblock_map(f"{prefix}.middle_block.0", path + ("mid_res1",)))
    m.update(attn_map(f"{prefix}.middle_block.1", path + ("mid_attn",)))
    m.update(resblock_map(f"{prefix}.middle_block.2", path + ("mid_res2",)))
    if encoder_only:
        return m
    for bi, (_, _, attn, up) in enumerate(output_plan):
        ref = f"{prefix}.output_blocks.{bi}"
        m.update(resblock_map(f"{ref}.0", path + (f"out_{bi}_res",)))
        sub = 1
        if attn:
            m.update(attn_map(f"{ref}.{sub}", path + (f"out_{bi}_attn",)))
            sub += 1
        if up:
            m.update(_conv(f"{ref}.{sub}.conv", path + (f"out_{bi}_up", "conv")))
    m.update(_gn(f"{prefix}.out.0", path + ("out_norm",)))
    m.update(_conv(f"{prefix}.out.2", path + ("out_conv",)))
    return m


def controlnet_map(prefix: str, path: Path, **unet_kwargs) -> Dict[str, Entry]:
    m = unet_map(prefix, path, encoder_only=True, **unet_kwargs)
    for i, ri in enumerate((0, 2, 4, 6, 8, 10, 12)):
        m.update(_conv(f"{prefix}.input_hint_block.{ri}", path + ("hint_stack", f"hint_conv{i}")))
    m.update(_conv(f"{prefix}.input_hint_block.14", path + ("hint_stack", "hint_conv_out")))
    input_plan, _, _ = plan_blocks(unet_kwargs["model_channels"],
                                   tuple(unet_kwargs["channel_mult"]),
                                   unet_kwargs["num_res_blocks"],
                                   tuple(unet_kwargs["attention_resolutions"]))
    for i in range(len(input_plan)):
        m.update(_conv(f"{prefix}.zero_convs.{i}.0", path + (f"zero_conv_{i}",)))
    m.update(_conv(f"{prefix}.middle_block_out.0", path + ("middle_block_out",)))
    return m


def _vae_resblock(ref: str, path: Path) -> Dict[str, Entry]:
    m = {}
    for n in ("norm1", "norm2"):
        m.update(_gn(f"{ref}.{n}", path + (n,)))
    for n in ("conv1", "conv2", "nin_shortcut"):  # nin_shortcut absent = identity
        m.update(_conv(f"{ref}.{n}", path + (n,)))
    return m


def _vae_attn(ref: str, path: Path) -> Dict[str, Entry]:
    m = _gn(f"{ref}.norm", path + ("norm",))
    for n in ("q", "k", "v", "proj_out"):
        m.update(_conv(f"{ref}.{n}", path + (n,)))
    return m


def vae_encoder_map(prefix: str, path: Path, ch_mult, num_res_blocks: int
                    ) -> Dict[str, Entry]:
    """The VAE encoder under ``prefix`` (with ``prefix`` '', the names of a
    ``GaussianEncoder``), its attention at ``attn_resolutions`` included
    (JAX ``down_{l}_attn_{i}``; left out where the encoder has none)."""
    pre = f"{prefix}." if prefix else ""
    m = _conv(f"{pre}conv_in", path + ("conv_in",))
    for lv in range(len(ch_mult)):
        for i in range(num_res_blocks):
            m.update(_vae_resblock(f"{pre}down.{lv}.block.{i}", path + (f"down_{lv}_block_{i}",)))
            m.update(_vae_attn(f"{pre}down.{lv}.attn.{i}", path + (f"down_{lv}_attn_{i}",)))
        if lv != len(ch_mult) - 1:
            m.update(_conv(f"{pre}down.{lv}.downsample.conv", path + (f"down_{lv}_downsample",)))
    m.update(_vae_mid_out(pre, path))
    return m


def _vae_mid_out(pre: str, path: Path) -> Dict[str, Entry]:
    m = _vae_resblock(f"{pre}mid.block_1", path + ("mid_block_1",))
    m.update(_vae_attn(f"{pre}mid.attn_1", path + ("mid_attn_1",)))
    m.update(_vae_resblock(f"{pre}mid.block_2", path + ("mid_block_2",)))
    m.update(_gn(f"{pre}norm_out", path + ("norm_out",)))
    m.update(_conv(f"{pre}conv_out", path + ("conv_out",)))
    return m


def vae_map(prefix: str, path: Path, ch_mult, num_res_blocks: int) -> Dict[str, Entry]:
    dec = path + ("decoder",)
    m = vae_encoder_map(f"{prefix}.encoder", path + ("encoder",), ch_mult, num_res_blocks)
    m.update(_vae_mid_out(f"{prefix}.decoder.", dec))
    m.update(_conv(f"{prefix}.decoder.conv_in", dec + ("conv_in",)))
    for lv in range(len(ch_mult)):
        for i in range(num_res_blocks + 1):
            m.update(_vae_resblock(f"{prefix}.decoder.up.{lv}.block.{i}",
                                   dec + (f"up_{lv}_block_{i}",)))
        if lv != 0:
            m.update(_conv(f"{prefix}.decoder.up.{lv}.upsample.conv",
                           dec + (f"up_{lv}_upsample",)))
    m.update(_conv(f"{prefix}.quant_conv", path + ("quant_conv",)))
    m.update(_conv(f"{prefix}.post_quant_conv", path + ("post_quant_conv",)))
    return m


def _clip_blocks(prefix: str, path: Path, layers: int) -> Dict[str, Entry]:
    m = {}
    for i in range(layers):
        ref, p = f"{prefix}.transformer.resblocks.{i}", path + (f"resblock_{i}",)
        m.update(_norm_flat(f"{ref}.ln_1", p + ("ln_1",)))
        m.update(_norm_flat(f"{ref}.ln_2", p + ("ln_2",)))
        m.update(_dense(f"{ref}.attn.out_proj", p + ("attn", "out_proj")))
        m.update(_dense(f"{ref}.mlp.c_fc", p + ("mlp_fc",)))
        m.update(_dense(f"{ref}.mlp.c_proj", p + ("mlp_proj",)))
    return m


def clip_map(prefix: str, path: Path, layers: int) -> Dict[str, Entry]:
    m = {f"{prefix}.token_embedding.weight": (path + ("token_embedding", "embedding"), _none),
         f"{prefix}.positional_embedding": (path + ("positional_embedding",), _none)}
    m.update(_norm_flat(f"{prefix}.ln_final", path + ("ln_final",)))
    m.update(_clip_blocks(prefix, path, layers))
    return m


def clip_vision_map(prefix: str, path: Path, layers: int) -> Dict[str, Entry]:
    """``CLIPVisionTransformer`` under open_clip's names (the q/k/v packing
    is ``clip_state_dict_from_jax``'s)."""
    m = {f"{prefix}.conv1.weight": (path + ("patch_embed", "kernel"), _conv2d)}
    for n in ("class_embedding", "positional_embedding", "proj"):
        m[f"{prefix}.{n}"] = (path + (n,), _none)
    m.update(_norm_flat(f"{prefix}.ln_pre", path + ("ln_pre",)))
    m.update(_norm_flat(f"{prefix}.ln_post", path + ("ln_post",)))
    m.update(_clip_blocks(prefix, path, layers))
    return m


def downsampler_map(prefix: str, path: Path) -> Dict[str, Entry]:
    """``DownSampler``: the JAX module's conv0..conv5 and conv_out at the
    ``net`` Sequential's indices 0, 2, ..., 12."""
    m = {}
    for i in range(6):
        m.update(_conv(f"{prefix}.net.{2 * i}", path + (f"conv{i}",)))
    m.update(_conv(f"{prefix}.net.12", path + ("conv_out",)))
    return m


def _conv3d_flat(ref: str, path: Path, name: str) -> Dict[str, Entry]:
    """A temporal Conv3d ``ref`` that the JAX module keeps as two flat
    params, ``{name}_kernel`` and ``{name}_bias``."""
    return {f"{ref}.weight": (path + (f"{name}_kernel",), _conv3d),
            f"{ref}.bias": (path + (f"{name}_bias",), _none)}


def vae_temporal_map(ref: str, path: Path, block: str) -> Dict[str, Entry]:
    """The block of ``models/vae_temporal.py`` named ``block`` (entries of
    the params it lacks, such as an absent shortcut, are left out by
    ``apply_map``)."""
    pre = f"{ref}." if ref else ""
    m = {}
    if block in ("Upsample1D", "Downsample1D"):
        return _conv(f"{pre}conv", path + ("conv",), _conv1d)
    if block == "AttnBlockTemporal":
        m.update(_gn(f"{pre}norm", path + ("norm",)))
        for n in ("q", "k", "v", "proj_out"):
            m.update(_conv(f"{pre}{n}", path + (n,), _conv1d))
        return m
    t = _conv1d if block == "ResnetBlock1D" else _conv2d
    for n in ("norm1", "norm2"):
        m.update(_gn(f"{pre}{n}", path + (n,)))
    for n in ("conv1", "conv2"):
        m.update(_conv(f"{pre}{n}", path + (n,), t))
    for n in ("conv_shortcut", "nin_shortcut"):
        m.update(_conv(f"{pre}{n}", path + (n,)))
        if block == "ResnetBlock3D":
            m.update(_conv3d_flat(f"{pre}{n}_temporal", path, f"{n}_temporal"))
    if block == "ResnetBlock3D":
        for i in (1, 2):
            m.update(_gn(f"{pre}conv{i}_temporal_norm", path + (f"conv{i}_temporal_norm",)))
            m.update(_conv3d_flat(f"{pre}conv{i}_temporal", path, f"conv{i}_temporal"))
    return m


def flatten(tree: Mapping[str, Any], prefix: Path = ()) -> Dict[Path, np.ndarray]:
    """Nested dicts of arrays -> {path tuple: numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, dtype=np.float32)
    return out


def apply_map(flat: Dict[Path, np.ndarray], mapping: Dict[str, Entry]) -> Dict[str, torch.Tensor]:
    """Entries whose flax parameter does not exist (identity skips) are left out."""
    return {ref: torch.from_numpy(np.ascontiguousarray(t(flat[p])))
            for ref, (p, t) in mapping.items() if p in flat}


def _packed_qkv(flat: Dict[Path, np.ndarray], base: Path, ref: str) -> Dict[str, torch.Tensor]:
    """The q/k/v Dense layers under ``base`` -> torch MultiheadAttention's
    ``{ref}.in_proj_weight`` and ``in_proj_bias``, rows [q; k; v]."""
    names = ("q_proj", "k_proj", "v_proj")
    return {f"{ref}.in_proj_weight": torch.from_numpy(np.concatenate(
                [flat[base + (n, "kernel")].T for n in names])),
            f"{ref}.in_proj_bias": torch.from_numpy(np.concatenate(
                [flat[base + (n, "bias")] for n in names]))}


def _clip_qkv(flat: Dict[Path, np.ndarray], prefix: str, path: Path, layers: int):
    """Each block's q/k/v -> ``in_proj`` (``_packed_qkv``)."""
    sd = {}
    for i in range(layers):
        sd.update(_packed_qkv(flat, path + (f"resblock_{i}", "attn"),
                              f"{prefix}.transformer.resblocks.{i}.attn"))
    return sd


def clip_state_dict_from_jax(params: Mapping[str, Any], prefix: str, layers: int,
                             vision: bool = False) -> Dict[str, torch.Tensor]:
    """A JAX CLIP text tower's tree (``CLIPTextTransformer``; with ``vision``
    a ``CLIPVisionTransformer``'s) -> the port's entries under ``prefix``,
    the q/k/v Dense layers packed as open_clip's ``in_proj``."""
    flat = flatten(params)
    mapping = (clip_vision_map if vision else clip_map)(prefix, (), layers)
    return {**apply_map(flat, mapping), **_clip_qkv(flat, prefix, (), layers)}


# the text towers whose trees the JAX engine keeps under "clip", with their
# default depth
_TEXT_TOWERS = {"FrozenOpenCLIPEmbedder": 24, "FrozenOpenCLIPEmbedder2": 24,
                "FrozenCLIPEmbedder": 12}


def state_dict_from_jax(params: Mapping[str, Any], config: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """``params``: the JAX engine's trees as nested dicts of numpy arrays,
    ``{"model": ..., "first_stage": ..., "clip": ...}``; ``config``: the
    engine config (``configs.TINY_CPU["model"]`` and the like), which fixes
    the block plan, the ``label_emb`` variant and the attention form. Returns
    the port's state dict, fp32, keyed by the reference checkpoint's names."""
    p = config["params"]
    net = p["network_config"]["params"]
    cnet = (net.get("controlnet_config") or {}).get("params") or net

    def kwargs(c):
        return dict(model_channels=c["model_channels"], channel_mult=c["channel_mult"],
                    num_res_blocks=c["num_res_blocks"],
                    attention_resolutions=c["attention_resolutions"],
                    transformer_depth=c.get("transformer_depth", 1),
                    insert_crossview=c.get("insert_crossview", True),
                    num_classes=c.get("num_classes"),
                    legacy=not c.get("use_spatial_transformer", True))

    dd = p["first_stage_config"]["params"]["ddconfig"]
    mapping = {}
    mapping.update(unet_map("model.diffusion_model", ("model", "unet"), **kwargs(net)))
    mapping.update(controlnet_map("model.diffusion_model.controlnet",
                                  ("model", "controlnet"), **kwargs(cnet)))
    mapping.update(vae_map("first_stage_model", ("first_stage",),
                           dd.get("ch_mult", (1, 2, 4, 4)), dd.get("num_res_blocks", 2)))
    flat = flatten({k: v for k, v in params.items() if k in ("model", "first_stage")})
    sd = apply_map(flat, mapping)
    for i, emb in enumerate(p["conditioner_config"]["params"]["emb_models"]):
        name = emb["target"].rsplit(".", 1)[-1]
        if name in _TEXT_TOWERS:
            layers = (emb.get("params") or {}).get("layers", _TEXT_TOWERS[name])
            sd.update(clip_state_dict_from_jax(params["clip"], f"conditioner.embedders.{i}.model",
                                               layers))
    return sd


# --------------------------------------------------------------------------
# StreamPETR detector (mmdet names): the inverse of
# panacea_tpu/utils/convert.py:910-1178 and of its q/k/v split (:1482-1496)
# --------------------------------------------------------------------------

def _bn(ref: str, path: Path) -> Dict[str, Entry]:
    return {f"{ref}.weight": (path + ("scale",), _none), f"{ref}.bias": (path + ("bias",), _none),
            f"{ref}.running_mean": (path + ("mean",), _none),
            f"{ref}.running_var": (path + ("var",), _none)}


def _mln(ref: str, path: Path) -> Dict[str, Entry]:
    m = _dense(f"{ref}.reduce.0", path + ("reduce",))
    m.update(_dense(f"{ref}.gamma", path + ("gamma",)))
    m.update(_dense(f"{ref}.beta", path + ("beta",)))
    return m


def resnet50_map(prefix: str, path: Path, stage_blocks) -> Dict[str, Entry]:
    m = {f"{prefix}.conv1.weight": (path + ("conv1", "kernel"), _conv2d)}
    m.update(_bn(f"{prefix}.bn1", path + ("bn1",)))
    for s, n in enumerate(stage_blocks):
        for i in range(n):
            ref, p = f"{prefix}.layer{s + 1}.{i}", path + (f"layer{s + 1}_{i}",)
            for ci in (1, 2, 3):
                m[f"{ref}.conv{ci}.weight"] = (p + (f"conv{ci}", "kernel"), _conv2d)
                m.update(_bn(f"{ref}.bn{ci}", p + (f"bn{ci}",)))
            if i == 0:
                m[f"{ref}.downsample.0.weight"] = (p + ("ds_conv", "kernel"), _conv2d)
                m.update(_bn(f"{ref}.downsample.1", p + ("ds_bn",)))
    return m


def fpn_map(prefix: str, path: Path, num_laterals: int, num_outs: int) -> Dict[str, Entry]:
    m = {}
    for i in range(num_laterals):
        m.update(_conv(f"{prefix}.lateral_convs.{i}.conv", path + (f"lateral_{i}",)))
    for i in range(num_outs):
        m.update(_conv(f"{prefix}.fpn_convs.{i}.conv", path + (f"fpn_{i}",)))
    return m


def sparse_head_map(prefix: str, path: Path, num_layers: int,
                    proposal_queries: bool = False) -> Dict[str, Entry]:
    """SparseHead's names; with ``proposal_queries`` also SparseHeadv3's
    ``input_proj`` and ``context_embedding`` (the inverse of
    ``build_sparse_head_mapping``, ``panacea_tpu/utils/convert.py:1099-1130``)."""
    m = {f"{prefix}.reference_points.weight": (path + ("reference_points",), _none),
         f"{prefix}.pseudo_reference_points.weight": (path + ("pseudo_reference_points",),
                                                      _none)}
    if proposal_queries:
        for i in (0, 3):
            m.update(_dense(f"{prefix}.input_proj.{i}", path + ("input_proj", f"layers_{i}")))
        for i in (1, 4):
            m.update(_norm_flat(f"{prefix}.input_proj.{i}", path + ("input_proj", f"layers_{i}")))
        for i in (0, 2):
            m.update(_dense(f"{prefix}.context_embedding.{i}",
                            path + ("context_embedding", f"layers_{i}")))
    for ref, p in (("query_embedding.0", "query_embedding/layers_0"),
                   ("query_embedding.2", "query_embedding/layers_2"),
                   ("time_embedding.0", "time_embedding/layers_0"),
                   ("cls_branches.0.0", "cls_branch/layers_0"),
                   ("cls_branches.0.3", "cls_branch/layers_3"),
                   ("cls_branches.0.6", "cls_branch/layers_6"),
                   ("reg_branches.0.0", "reg_branch/layers_0"),
                   ("reg_branches.0.2", "reg_branch/layers_2"),
                   ("reg_branches.0.4", "reg_branch/layers_4")):
        m.update(_dense(f"{prefix}.{ref}", path + tuple(p.split("/"))))
    for ref, p in (("time_embedding.1", "time_embedding/layers_1"),
                   ("cls_branches.0.1", "cls_branch/layers_1"),
                   ("cls_branches.0.4", "cls_branch/layers_4")):
        m.update(_norm_flat(f"{prefix}.{ref}", path + tuple(p.split("/"))))
    for ref, p in (("ego_pose_pe", "ego_pose_pe"), ("ego_pose_memory", "ego_pose_memory"),
                   ("transformer.spatial_alignment", "spatial_alignment")):
        m.update(_mln(f"{prefix}.{ref}", path + (p,)))
    for i in range(num_layers):
        ref = f"{prefix}.transformer.decoder.layers.{i}"
        d = path + (f"cross_attn_{i}",)
        m.update(_dense(f"{ref}.attentions.0.attn.out_proj", path + (f"self_attn_{i}", "out_proj")))
        for name, p in (("weights_fc", "weights_fc"), ("output_proj", "output_proj"),
                        ("learnable_fc", "learnable_fc"), ("cam_embed.0", "cam_embed_fc1"),
                        ("cam_embed.2", "cam_embed_fc2")):
            m.update(_dense(f"{ref}.attentions.1.{name}", d + (p,)))
        m.update(_norm_flat(f"{ref}.attentions.1.cam_embed.4", d + ("cam_embed_ln",)))
        m.update(_dense(f"{ref}.ffns.0.layers.0.0", path + (f"ffn_{i}", "fc1")))
        m.update(_dense(f"{ref}.ffns.0.layers.1", path + (f"ffn_{i}", "fc2")))
        for ni in range(3):
            m.update(_norm_flat(f"{ref}.norms.{ni}", path + (f"norm_{3 * i + ni}",)))
    return m


def atss_head_map(prefix: str, path: Path, stacked_convs: int = 4) -> Dict[str, Entry]:
    """The ATSS head's convolutions (the inverse of
    ``panacea_tpu/utils/convert.py:1299`` ``build_atss_head_mapping``); the
    per-level ``scales`` vector is carried by ``streampetr_state_dict_from_jax``."""
    m = {}
    for i in range(stacked_convs):
        m.update(_conv(f"{prefix}.cls_convs.{i}.conv", path + (f"cls_conv{i}",)))
        m.update(_conv(f"{prefix}.reg_convs.{i}.conv", path + (f"reg_conv{i}",)))
    for ref, p in (("atss_cls", "cls_out"), ("atss_reg", "reg_out"),
                   ("atss_centerness", "ctr_out")):
        m.update(_conv(f"{prefix}.{ref}", path + (p,)))
    return m


def vovnet_map(prefix: str, path: Path, num_blocks, num_layers: int) -> Dict[str, Entry]:
    """VoVNet's mmdet names (the inverse of ``build_vovnet_mapping``,
    ``panacea_tpu/utils/convert.py:963-1002``)."""
    m = {}
    for k in (1, 2, 3):
        ref, p = f"{prefix}.stem.stem_{k}", path + (f"stem{k}",)
        m[f"{ref}/conv.weight"] = (p + ("conv", "kernel"), _conv2d)
        m.update(_bn(f"{ref}/norm", p + ("bn",)))
    for si, nb in enumerate(num_blocks):
        s = si + 2
        for bi in range(nb):
            ref, p = f"{prefix}.stage{s}.OSA{s}_{bi + 1}", path + (f"stage{s}_block{bi}",)
            for li in range(num_layers):
                lref = f"{ref}.layers.{li}.OSA{s}_{bi + 1}_{li}"
                m[f"{lref}/conv.weight"] = (p + (f"conv{li}", "conv", "kernel"), _conv2d)
                m.update(_bn(f"{lref}/norm", p + (f"conv{li}", "bn")))
            cref = f"{ref}.concat.OSA{s}_{bi + 1}_concat"
            m[f"{cref}/conv.weight"] = (p + ("concat_conv", "conv", "kernel"), _conv2d)
            m.update(_bn(f"{cref}/norm", p + ("concat_conv", "bn")))
            m.update(_conv(f"{ref}.ese.fc", p + ("ese", "fc")))
    return m


def petr_head_map(prefix: str, path: Path, num_layers: int,
                  with_traj: bool = False) -> Dict[str, Entry]:
    """StreamPETRHead's names (the inverse of ``build_petr_head_mapping``,
    ``panacea_tpu/utils/convert.py:1181-1254``; with ``with_traj``
    PETRMotionHead's trajectory branch). The packed ``in_proj`` of both
    attentions is carried by ``streampetr_state_dict_from_jax``."""
    m = {f"{prefix}.reference_points.weight": (path + ("reference_points",), _none),
         f"{prefix}.pseudo_reference_points.weight": (path + ("pseudo_reference_points",),
                                                      _none)}
    dense = [("query_embedding.0", "query_embedding/layers_0"),
             ("query_embedding.2", "query_embedding/layers_2"),
             ("time_embedding.0", "time_embedding/layers_0"),
             ("position_encoder.0", "position_encoder/layers_0"),
             ("position_encoder.2", "position_encoder/layers_2"),
             ("memory_embed.0", "memory_embed/layers_0"),
             ("memory_embed.2", "memory_embed/layers_2"),
             ("featurized_pe.conv_reduce", "featurized_pe/conv_reduce"),
             ("featurized_pe.conv_expand", "featurized_pe/conv_expand"),
             ("cls_branches.0.0", "cls_branch/layers_0"),
             ("cls_branches.0.3", "cls_branch/layers_3"),
             ("cls_branches.0.6", "cls_branch/layers_6"),
             ("reg_branches.0.0", "reg_branch/layers_0"),
             ("reg_branches.0.2", "reg_branch/layers_2"),
             ("reg_branches.0.4", "reg_branch/layers_4")]
    if with_traj:
        dense += [(f"traj_branches.0.{j}", f"traj_branch/layers_{j}") for j in (0, 2, 4)]
        m[f"{prefix}.traj_embedding.weight"] = (path + ("traj_embedding",), _none)
    for ref, p in dense:
        m.update(_dense(f"{prefix}.{ref}", path + tuple(p.split("/"))))
    for ref, p in (("time_embedding.1", "time_embedding/layers_1"),
                   ("cls_branches.0.1", "cls_branch/layers_1"),
                   ("cls_branches.0.4", "cls_branch/layers_4"),
                   ("transformer.decoder.post_norm", "post_norm")):
        m.update(_norm_flat(f"{prefix}.{ref}", path + tuple(p.split("/"))))
    for name in ("ego_pose_pe", "ego_pose_memory", "spatial_alignment"):
        m.update(_mln(f"{prefix}.{name}", path + (name,)))
    for i in range(num_layers):
        ref = f"{prefix}.transformer.decoder.layers.{i}"
        m.update(_dense(f"{ref}.attentions.0.attn.out_proj", path + (f"self_attn_{i}", "out_proj")))
        m.update(_dense(f"{ref}.attentions.1.attn.out_proj",
                        path + (f"cross_attn_{i}", "out_proj")))
        m.update(_dense(f"{ref}.ffns.0.layers.0.0", path + (f"ffn_{i}", "fc1")))
        m.update(_dense(f"{ref}.ffns.0.layers.1", path + (f"ffn_{i}", "fc2")))
        for ni in range(3):
            m.update(_norm_flat(f"{ref}.norms.{ni}", path + (f"norm_{3 * i + ni}",)))
    return m


def eva_map(prefix: str, path: Path, depth: int, residual_block_indexes=(),
            scale_factors=(4.0, 2.0, 1.0, 0.5)) -> Dict[str, Entry]:
    """EVA-02's reference names (the inverse of ``build_eva_mapping``,
    ``panacea_tpu/utils/convert.py:1004-1066``, with ``pos_embed`` at the
    working grid in both packages)."""
    m = _conv(f"{prefix}.patch_embed.proj", path + ("patch_embed",))
    m[f"{prefix}.pos_embed"] = (path + ("pos_embed",), _none)
    for i in range(depth):
        ref, p = f"{prefix}.blocks.{i}", path + (f"block_{i}",)
        for n in ("norm1", "norm2"):
            m.update(_norm_flat(f"{ref}.{n}", p + (n,)))
        for n in ("q_proj", "k_proj", "v_proj"):
            m.update(_dense(f"{ref}.attn.{n}", p + ("attn", n), bias=False))
        for n in ("q_bias", "v_bias"):
            m[f"{ref}.attn.{n}"] = (p + ("attn", n), _none)
        m.update(_dense(f"{ref}.attn.proj", p + ("attn", "proj")))
        for n in ("w1", "w2", "w3"):
            m.update(_dense(f"{ref}.mlp.{n}", p + (n,)))
        m.update(_norm_flat(f"{ref}.mlp.ffn_ln", p + ("ffn_ln",)))
        if i in residual_block_indexes:
            for ci in (1, 2, 3):
                m[f"{ref}.residual.conv{ci}.weight"] = (p + ("residual", f"conv{ci}", "kernel"),
                                                        _conv2d)
                m.update(_norm_flat(f"{ref}.residual.norm{ci}", p + ("residual", f"norm{ci}")))
    ad = path + ("adapter",)
    for scale in scale_factors:
        st = int(np.log2(16 / scale))
        ref, nm = f"{prefix}.adapter.simfp_{st}", f"simfp_{st}"
        # the Sequential indices of each scale (eva.py:741-781)
        if scale == 4.0:
            m.update(_conv(f"{ref}.0", ad + (f"{nm}_up1",), _deconv2d))
            m.update(_norm_flat(f"{ref}.1", ad + (f"{nm}_upln",)))
            m.update(_conv(f"{ref}.3", ad + (f"{nm}_up2",), _deconv2d))
            lat = 4
        elif scale == 2.0:
            m.update(_conv(f"{ref}.0", ad + (f"{nm}_up1",), _deconv2d))
            lat = 1
        else:
            lat = 0 if scale == 1.0 else 1
        for idx, name in ((lat, "lateral"), (lat + 1, "out")):
            m[f"{ref}.{idx}.weight"] = (ad + (f"{nm}_{name}", "kernel"), _conv2d)
            m.update(_norm_flat(f"{ref}.{idx}.norm", ad + (f"{nm}_{name}_ln",)))
    return m


def _eva_plan(flat: Dict[Path, np.ndarray]):
    """(depth, residual block indexes, scale factors) of the EVAViT in ``flat``."""
    blocks = {int(p[1][len("block_"):]) for p in flat
              if p[0] == "backbone" and p[1].startswith("block_")}
    residual = tuple(sorted(i for i in blocks if ("backbone", f"block_{i}", "residual", "conv1",
                                                  "kernel") in flat))
    stages = sorted({int(p[2].split("_")[1]) for p in flat if p[:2] == ("backbone", "adapter")})
    return len(blocks), residual, tuple(16.0 / 2 ** st for st in stages)


def focal_head_map(prefix: str, path: Path) -> Dict[str, Entry]:
    """FocalHead's reference names (the inverse of ``build_focal_head_mapping``,
    ``panacea_tpu/utils/convert.py:1256-1275``)."""
    m = {}
    for tower in ("shared_cls", "shared_reg"):
        m.update(_conv(f"{prefix}.{tower}.0", path + (f"{tower}_conv",)))
        m.update(_norm_flat(f"{prefix}.{tower}.1", path + (f"{tower}_gn",)))
    for head in ("cls", "centerness", "ltrb", "center2d"):
        m.update(_conv(f"{prefix}.{head}", path + (head,)))
    return m


def _vovnet_plan(flat: Dict[Path, np.ndarray]):
    """(blocks a stage, convolutions a block) of the VoVNet in ``flat``."""
    blocks = [len({p[1] for p in flat if p[0] == "backbone" and p[1].startswith(f"stage{s}_")})
              for s in range(2, 6)]
    layers = len({p[2] for p in flat if p[:2] == ("backbone", "stage2_block0")
                  and p[2].startswith("conv")})
    return blocks, layers


def streampetr_state_dict_from_jax(params: Mapping[str, Any], num_layers: int = 6,
                                   stage_blocks=(3, 4, 6, 3), num_outs: int = 5,
                                   atss_stacked_convs: int = 4, backbone: str = "r50",
                                   head: str = "sparse") -> Dict[str, torch.Tensor]:
    """The JAX ``StreamPETRWindow``'s parameter tree (nested dicts of numpy
    arrays; the ATSS head where the tree has ``roi_head``) -> the port
    detector's state dict, fp32, under the reference's mmdet names, as
    ``convert_streampetr_checkpoint`` takes them (``backbone`` 'r50',
    'vovnet' or 'eva', whose blocks are read off the tree; ``head``
    'sparse', 'sparse_v3', 'sparse_v4', 'petr', 'petr_dn' or 'motion').
    Each packed attention's q/k/v Dense
    layers become ``attentions.{0,1}.attn.in_proj_weight`` and
    ``in_proj_bias``, rows [q; k; v] (the sparse head's self-attention,
    both attentions of the PETR heads); the ATSS ``scales`` vector becomes
    mmcv's ``scales.{i}.scale`` scalars."""
    flat = flatten(params)
    if backbone == "r50":
        mapping = resnet50_map("img_backbone", ("backbone",), stage_blocks)
        mapping.update(fpn_map("img_neck", ("neck",), 3, num_outs))
    elif backbone == "vovnet":
        mapping = vovnet_map("img_backbone", ("backbone",), *_vovnet_plan(flat))
        mapping.update(fpn_map("img_neck", ("neck",), 2, num_outs))
    elif backbone == "eva":   # its adapter is the neck
        mapping = eva_map("img_backbone", ("backbone",), *_eva_plan(flat))
    else:
        raise ValueError(f"no port of backbone {backbone!r}")
    if head in ("sparse", "sparse_v3", "sparse_v4"):
        # v4 has SparseHead's tree; v3 adds its context-query modules, which
        # the JAX tree holds once the head has seen proposals
        mapping.update(sparse_head_map("pts_bbox_head", ("head",), num_layers,
                                       proposal_queries=("head", "input_proj", "layers_0",
                                                         "kernel") in flat))
        packed = (("attentions.0", "self_attn"),)
    elif head in ("petr", "petr_dn", "motion"):
        mapping.update(petr_head_map("pts_bbox_head", ("head",), num_layers,
                                     with_traj=head == "motion"))
        packed = (("attentions.0", "self_attn"), ("attentions.1", "cross_attn"))
    else:
        raise ValueError(f"no port of head {head!r}")
    mapping.update(atss_head_map("img_roi_head", ("roi_head",), atss_stacked_convs))
    sd = apply_map(flat, mapping)
    for i in range(num_layers):
        for ref, name in packed:
            sd.update(_packed_qkv(
                flat, ("head", f"{name}_{i}"),
                f"pts_bbox_head.transformer.decoder.layers.{i}.{ref}.attn"))
    scales = flat.get(("roi_head", "scales"))
    if scales is not None:
        sd.update({f"img_roi_head.scales.{i}.scale": torch.tensor(float(v))
                   for i, v in enumerate(scales)})
    return sd


# --------------------------------------------------------------------------
# The VAE's losses: LPIPS (the inverse of panacea_tpu/utils/convert.py:837-887,
# build_vgg16_lpips_mapping(naming="lpips")) and the PatchGAN discriminator
# (no JAX mapping: flax's own names)
# --------------------------------------------------------------------------

# torchvision vgg16.features index of each of the 13 convolutions, and the
# lpips slice that holds it
_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG16_SLICE_OF_CONV = (1, 1, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5)


def lpips_map(prefix: str = "", path: Path = ()) -> Dict[str, Entry]:
    """``losses.lpips.LPIPS`` (reference lpips names) -> the JAX ``LPIPS`` tree."""
    p = f"{prefix}." if prefix else ""
    m = {}
    for li, (fi, si) in enumerate(zip(_VGG16_CONV_IDX, _VGG16_SLICE_OF_CONV)):
        m.update(_conv(f"{p}net.slice{si}.{fi}", path + ("vgg", f"conv{li}")))
    for k in range(5):
        m[f"{p}lin{k}.model.1.weight"] = (path + (f"lin{k}", "kernel"), _conv2d)
    return m


def nlayer_discriminator_map(prefix: str = "", path: Path = (),
                             n_layers: int = 3) -> Dict[str, Entry]:
    """``losses.vae_losses.NLayerDiscriminator`` (``main.{i}``) -> the JAX
    module's ``conv0``, ``conv{i}`` + ``GroupNorm_{i-1}``, ``conv_out``."""
    p = f"{prefix}." if prefix else ""
    m = _conv(f"{p}main.0", path + ("conv0",))
    for i in range(1, n_layers + 1):
        m[f"{p}main.{3 * i - 1}.weight"] = (path + (f"conv{i}", "kernel"), _conv2d)
        m.update(_norm_flat(f"{p}main.{3 * i}", path + (f"GroupNorm_{i - 1}",)))
    m.update(_conv(f"{p}main.{3 * n_layers + 2}", path + ("conv_out",)))
    return m


# --------------------------------------------------------------------------
# Metric towers: InceptionV3 (FID) and I3D (FVD), the inverse of
# panacea_tpu/utils/convert.py:766-903
# --------------------------------------------------------------------------

def _bn_stats(ref: str, path: Path) -> Dict[str, Entry]:
    return {f"{ref}.bn.weight": (path + ("bn_scale",), _none),
            f"{ref}.bn.bias": (path + ("bn_bias",), _none),
            f"{ref}.bn.running_mean": (path + ("bn_mean",), _none),
            f"{ref}.bn.running_var": (path + ("bn_var",), _none)}


# torchvision branch name -> the JAX module's, per Inception block kind
_INCEPTION_BRANCHES = {
    "A": {"branch1x1": "b1x1", "branch5x5_1": "b5_1", "branch5x5_2": "b5_2",
          "branch3x3dbl_1": "b3_1", "branch3x3dbl_2": "b3_2",
          "branch3x3dbl_3": "b3_3", "branch_pool": "bpool"},
    "B": {"branch3x3": "b3", "branch3x3dbl_1": "bd_1", "branch3x3dbl_2": "bd_2",
          "branch3x3dbl_3": "bd_3"},
    "C": {"branch1x1": "b1x1", "branch7x7_1": "b7_1", "branch7x7_2": "b7_2",
          "branch7x7_3": "b7_3", "branch7x7dbl_1": "bd_1", "branch7x7dbl_2": "bd_2",
          "branch7x7dbl_3": "bd_3", "branch7x7dbl_4": "bd_4", "branch7x7dbl_5": "bd_5",
          "branch_pool": "bpool"},
    "D": {"branch3x3_1": "b3_1", "branch3x3_2": "b3_2", "branch7x7x3_1": "b7_1",
          "branch7x7x3_2": "b7_2", "branch7x7x3_3": "b7_3", "branch7x7x3_4": "b7_4"},
    "E": {"branch1x1": "b1x1", "branch3x3_1": "b3_1", "branch3x3_2a": "b3_2a",
          "branch3x3_2b": "b3_2b", "branch3x3dbl_1": "bd_1", "branch3x3dbl_2": "bd_2",
          "branch3x3dbl_3a": "bd_3a", "branch3x3dbl_3b": "bd_3b", "branch_pool": "bpool"},
}
_INCEPTION_BLOCKS = (("Mixed_5b", "A"), ("Mixed_5c", "A"), ("Mixed_5d", "A"), ("Mixed_6a", "B"),
                     ("Mixed_6b", "C"), ("Mixed_6c", "C"), ("Mixed_6d", "C"), ("Mixed_6e", "C"),
                     ("Mixed_7a", "D"), ("Mixed_7b", "E"), ("Mixed_7c", "E"))


def inception_map() -> Dict[str, Entry]:
    m: Dict[str, Entry] = {}

    def convbn(ref, path):
        m[f"{ref}.conv.weight"] = (path + ("conv", "kernel"), _conv2d)
        m.update(_bn_stats(ref, path))

    for ref in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
                "Conv2d_4a_3x3"):
        convbn(ref, (ref.rsplit("_", 1)[0],))
    for block, kind in _INCEPTION_BLOCKS:
        for ref, ours in _INCEPTION_BRANCHES[kind].items():
            convbn(f"{block}.{ref}", (block, ours))
    return m


def i3d_map() -> Dict[str, Entry]:
    from panacea_tpu_torch.metrics_gen.i3d import MIXED

    m: Dict[str, Entry] = {}

    def unit(ref, path):
        m[f"{ref}.conv3d.weight"] = (path + ("conv", "kernel"), _conv3d)
        m.update(_bn_stats(ref, path))

    for ref in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"):
        unit(ref, (ref.rsplit("_", 1)[0],))
    for block, *_ in MIXED:
        for ref in ("b0", "b1a", "b1b", "b2a", "b2b", "b3b"):
            # pytorch-i3d's b3b is the JAX module's b3
            unit(f"{block}.{ref}", (block, "b3" if ref == "b3b" else ref))
    m["logits.conv3d.weight"] = (("logits", "conv", "kernel"), _conv3d)
    m["logits.conv3d.bias"] = (("logits", "conv", "bias"), _none)
    return m


def inception_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``InceptionV3``'s parameter tree (nested dicts of arrays) ->
    the port's state dict under torchvision's names, fp32."""
    return apply_map(flatten(params), inception_map())


def i3d_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``I3D``'s parameter tree -> the port's state dict under
    pytorch-i3d's names, fp32. A tree without ``logits`` (the JAX module
    initialised without ``return_logits``) gives no ``logits.*`` entries."""
    return apply_map(flatten(params), i3d_map())
