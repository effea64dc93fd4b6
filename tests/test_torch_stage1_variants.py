"""Stage 1 and the off-path network variants of the port against the JAX
package: the single-frame network of ``tiny_stage1.yaml`` in 'intra-view'
with cross-view and in 'full' without, the stage-1 CLI, the ``num_classes``
label embeddings, the legacy attention blocks, ResBlock3D's in-block
up/down form, the VAE encoder's attention and the temporal VAE blocks.

Every parameter is drawn on the port's side from a numpy seed and carried
to the JAX module, by the JAX package's own mapping where it has one
(``build_unet_mapping``) and else by ``panacea_tpu_torch.convert``'s maps
walked backwards (``torch_parity.to_jax``). Both run the same fp32 inputs.
Networks and their blocks agree within NET_TOL of the output's largest
value. The JAX networks run without remat and jitted, which changes
nothing of their values.

The tiny widths put one channel in each of the GroupNorms' 32 groups, so a
temporal norm over two frames normalises pairs of numbers: the rounding of
its inputs comes out amplified up to 1/sqrt(eps), in both packages alike
(flax's GroupNorm, in the legacy block, even takes the variance as E[x^2] -
E[x]^2). The label and legacy networks therefore run three frames a clip
(at two: 2.6e-4 and 0.10 of the output apart; at three: 4e-6 and 2e-5),
and the legacy one two channels a group.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import check, draw, to_jax, two_threads  # noqa: F401

import panacea_tpu.config as jconfig
from panacea_tpu.models import vae_temporal as jvt
from panacea_tpu.models.controlnet import ControlNet3D as JControlNet3D
from panacea_tpu.models.layers import ResBlock3D as JResBlock3D
from panacea_tpu.models.legacy_attention import LegacyAttentionBlock3D as JLegacy
from panacea_tpu.models.unet import UNetModel3D as JUNetModel3D
from panacea_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from panacea_tpu.registry import instantiate_from_config as jax_instantiate
from panacea_tpu.utils.convert import (build_controlnet_mapping, build_unet_mapping,
                                       convert_state_dict)
from panacea_tpu_torch import configs, convert
from panacea_tpu_torch.models import vae_temporal as pvt
from panacea_tpu_torch.models.controlnet import ControlledUNetModel3D, ControlNet3D
from panacea_tpu_torch.models.layers import ResBlock3D
from panacea_tpu_torch.models.legacy_attention import LegacyAttentionBlock3D
from panacea_tpu_torch.models.unet import UNetModel3D
from panacea_tpu_torch.models.vae import AutoencoderKL

pytestmark = pytest.mark.usefixtures("two_threads")
JAX_CONFIGS = os.path.join(os.path.dirname(__file__), "..", "panacea_tpu", "configs")
NET_TOL = 1e-4    # networks and their blocks: of the output's largest value
IH, IW, LH, LW = 16, 192, 2, 24   # tests/test_stage1.py's sizes


def net_config(name, overrides=()):
    cfg = jconfig.load_config(os.path.join(JAX_CONFIGS, f"{name}.yaml"))
    jconfig.apply_dotlist(cfg, list(overrides))
    net = cfg["model"]["params"]["network_config"]
    for p in (net["params"], net["params"]["controlnet_config"]["params"]):
        p["use_checkpoint"] = False
    return net


def plan(p, **extra):
    return dict(model_channels=p["model_channels"], channel_mult=p["channel_mult"],
                num_res_blocks=p["num_res_blocks"],
                attention_resolutions=p["attention_resolutions"],
                insert_crossview=p.get("insert_crossview", True), **extra)


def run_controlled(cfg, t, b=1, y=None, seed=0):
    """The JAX ControlledUNetModel3D of ``cfg`` and the port's on the same
    drawn weights (carried by the JAX package's mapping) and inputs."""
    p = cfg["params"]
    pnet = draw(ControlledUNetModel3D(**p), seed)
    mapping = build_unet_mapping("n", ("unet",), num_classes=p.get("num_classes"), **plan(p))
    cp = p["controlnet_config"]["params"]
    mapping.update(build_controlnet_mapping("n.controlnet", ("controlnet",),
                                            num_classes=cp.get("num_classes"), **plan(cp)))
    sd = {"n." + k: v.numpy() for k, v in pnet.state_dict().items()}
    params, _, unexpected = convert_state_dict(sd, mapping)
    assert not unexpected
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b * t, LH, LW, 8)).astype(np.float32)
    ts = rng.uniform(0, 999, (b * t,)).astype(np.float32)
    ctx = rng.standard_normal((b, 77, 64)).astype(np.float32)
    hint = rng.uniform(0, 1, (b * t, IH, IW, 19)).astype(np.float32)
    jcfg = copy.deepcopy(cfg)
    jcfg["params"].pop("adm_in_channels", None)   # not a field of the JAX class
    net = jax_instantiate(jcfg)
    want = jax.jit(lambda p, *a: net.apply({"params": p}, *a))(params, x, ts, ctx, hint, y)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                   hint=torch.from_numpy(hint),
                   y=None if y is None else torch.from_numpy(np.asarray(y)))
    assert got.shape == (b * t, LH, LW, 4)
    return got.numpy(), np.asarray(want)


FULL = ["model.params.network_config.params.spatial_only_attn_type=full",
        "model.params.network_config.params.insert_crossview=False",
        "model.params.network_config.params.controlnet_config.params.spatial_only_attn_type=full",
        "model.params.network_config.params.controlnet_config.params.insert_crossview=False"]


@pytest.mark.parametrize("mode", ["intra-view", "full"])
def test_stage1_network_matches_jax(mode):
    """tiny_stage1's single-frame ControlledUNetModel3D: 'intra-view' with
    the cross-view stage (BASELINE config 3), 'full' without (config 1)."""
    cfg = net_config("tiny_stage1", FULL if mode == "full" else ())
    assert cfg["params"]["num_frames"] == 1
    check(*run_controlled(cfg, t=1), NET_TOL, f"stage1 {mode}")


def test_full_mode_attends_over_the_whole_panorama():
    """'full' is one self-attention over all H*W tokens: moving a token of
    another view changes a view's output, which 'intra-view' forbids."""
    from panacea_tpu_torch.models.transformer import BasicTransformerBlock

    torch.manual_seed(0)
    x = torch.randn(1, 2, 24, 32)
    x2 = x.clone()
    x2[:, :, 20:] = torch.randn(1, 2, 4, 32)   # the last view only
    outs = {}
    for mode in ("full", "intra-view"):
        blk = BasicTransformerBlock(32, 2, 16, 64, mode).eval()
        ctx = torch.randn(1, 77, 64)
        with torch.no_grad():
            outs[mode] = (blk(x, ctx) - blk(x2, ctx))[:, :, :4].abs().max().item()
    assert outs["full"] > 1e-3 and outs["intra-view"] == 0.0


def test_stage1_cli_writes_its_outputs(tmp_path, monkeypatch):
    """``inference_torch.py --base tiny_stage1 --synthetic --device cpu``, at
    the tiny views' size (the CLI's full 256 x 512 views take about 45 s on
    a CPU): one frame per clip through the dataset, log_images and the
    writers."""
    from panacea_tpu_torch import inference

    monkeypatch.setattr(inference, "FULL_FINAL_DIM", inference.TINY_FINAL_DIM)
    out = inference.main(["--base", "tiny_stage1", "--synthetic", "--device", "cpu",
                          "--num_batches", "1", "--num_steps", "2", "--outdir", str(tmp_path)])
    assert out["done"] == 1
    gen = os.path.join(out["outdir"], "gen-nuscenes")
    views = sorted(os.listdir(gen))
    assert len(views) == 6
    assert all(os.listdir(os.path.join(gen, v)) == ["_000000.jpg"] for v in views)
    assert os.listdir(os.path.join(out["outdir"], "samples"))


LABEL_FRAMES = 3
LABELS = {"int": (dict(num_classes=10), lambda r: r.integers(0, 10, (2,)).astype(np.int32)),
          "continuous": (dict(num_classes="continuous"),
                         lambda r: r.uniform(0, 5, (2,)).astype(np.float32)),
          "sequential": (dict(num_classes="sequential", adm_in_channels=12),
                         lambda r: r.standard_normal((2, 12)).astype(np.float32))}


@pytest.mark.parametrize("form", sorted(LABELS))
def test_label_embeddings_match_jax(form):
    """``num_classes`` in the UNet and the ControlNet at tiny_cpu's widths,
    one level deep with the middle block's transformer alone; y per clip for two clips of three frames, spread over each clip's
    frames (jnp.repeat)."""
    extra, sample_y = LABELS[form]
    dots = [f"model.params.network_config.params.{p}{k}"
            for p in ("", "controlnet_config.params.")
            for k in (f"num_frames={LABEL_FRAMES}", "channel_mult=[1]",
                      "attention_resolutions=[]")]
    for k, v in extra.items():
        v = repr(v)
        dots += [f"model.params.network_config.params.{k}={v}",
                 f"model.params.network_config.params.controlnet_config.params.{k}={v}"]
    cfg = net_config("tiny_cpu", dots)
    check(*run_controlled(cfg, t=LABEL_FRAMES, b=2, y=sample_y(np.random.default_rng(7))),
          NET_TOL,
          f"label_emb {form}")


def test_label_embedding_keys_are_the_references():
    net = UNetModel3D(model_channels=32, channel_mult=(1,), num_res_blocks=1,
                      attention_resolutions=(), num_head_channels=16, context_dim=64,
                      num_frames=2, num_classes="sequential", adm_in_channels=12)
    assert {k for k in net.state_dict() if k.startswith("label_emb")} == {
        "label_emb.0.0.weight", "label_emb.0.0.bias", "label_emb.0.2.weight",
        "label_emb.0.2.bias"}
    with pytest.raises(ValueError, match="needs y"):
        net(torch.zeros(2, 4, 4, 8), torch.zeros(2), torch.zeros(1, 77, 64))


@pytest.mark.parametrize("new_order", [False, True])
def test_legacy_block_matches_jax(new_order):
    """tests/test_legacy_attention.py's shapes, both qkv channel orders."""
    b, t, h, w, c, heads = 1, 2, 4, 6, 64, 4
    x = np.random.RandomState(0).randn(b * t, h, w, c).astype(np.float32)
    pblk = draw(LegacyAttentionBlock3D(c, heads, num_frames=t, use_new_attention_order=new_order))
    params = to_jax(pblk, convert.legacy_attention_map("n", ()))
    jblk = JLegacy(channels=c, num_heads=heads, num_frames=t, use_new_attention_order=new_order)
    with torch.no_grad():
        got = pblk(torch.from_numpy(x)).numpy()
    check(got, np.asarray(jblk.apply({"params": params}, jnp.asarray(x))), NET_TOL,
          f"legacy new_order={new_order}")
    # the dead qkv_temporal exists and changes nothing
    with torch.no_grad():
        pblk.qkv_temporal.weight.add_(1.0)
        assert np.array_equal(pblk(torch.from_numpy(x)).numpy(), got)


def test_legacy_unet_and_controlnet_match_jax():
    """use_spatial_transformer=False: legacy blocks at every attention site
    of the UNet and of the ControlNet; the context is ignored."""
    kw = dict(in_channels=8, model_channels=64, num_res_blocks=1, attention_resolutions=(1,),
              channel_mult=(1,), num_head_channels=16, num_frames=3, context_dim=64,
              use_spatial_transformer=False, use_checkpoint=False)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 4, 24, 8)).astype(np.float32)
    ts = np.array([10.0, 700.0, 300.0], np.float32)
    ctx = rng.standard_normal((1, 77, 64)).astype(np.float32)
    hint = rng.uniform(0, 1, (3, 32, 192, 19)).astype(np.float32)
    blocks = dict(model_channels=64, channel_mult=(1,), num_res_blocks=1,
                  attention_resolutions=(1,), legacy=True)
    pun = draw(UNetModel3D(out_channels=4, **kw))
    pcn = draw(ControlNet3D(hint_channels=19, **kw), seed=1)
    assert not any("transformer" in k for k in pun.state_dict())
    up = to_jax(pun, convert.unet_map("n", (), **blocks))
    cp = to_jax(pcn, convert.controlnet_map("n", (), **blocks))
    t = [torch.from_numpy(a) for a in (x, ts, ctx, hint)]
    with torch.no_grad():
        check(pun(*t[:3]).numpy(), JUNetModel3D(out_channels=4, **kw).apply(
            {"params": up}, x, ts, ctx), NET_TOL, "legacy unet")
        got = pcn(*t[:3], hint=t[3])
        want = JControlNet3D(hint_channels=19, **kw).apply({"params": cp}, x, hint, ts, ctx)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            check(g.numpy(), w, NET_TOL, "legacy controlnet")
        assert np.array_equal(pun(*t[:2], torch.zeros_like(t[2])).numpy(), pun(*t[:3]).numpy())


@pytest.mark.parametrize("way", ["up", "down"])
def test_resblock_updown_matches_jax(way):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 6, 10, 32)).astype(np.float32)
    emb = rng.standard_normal((4, 128)).astype(np.float32)
    pblk = draw(ResBlock3D(32, 128, 48, num_frames=2, **{way: True}))
    assert not hasattr(pblk, "in_layers_temporal")
    params = to_jax(pblk, convert.resblock_map("n", ()))
    jblk = JResBlock3D(channels=32, emb_channels=128, out_channels=48, num_frames=2,
                       **{way: True})
    with torch.no_grad():
        got = pblk(torch.from_numpy(x), torch.from_numpy(emb)).numpy()
    assert got.shape == ((4, 12, 20, 48) if way == "up" else (4, 3, 5, 48))
    check(got, jblk.apply({"params": params}, x, emb), NET_TOL, f"resblock {way}")


def test_vae_encoder_attention_matches_jax():
    """attn_resolutions: attention after each block of the 32 and 16
    levels of the encoder (the JAX decoder has none there)."""
    dd = dict(double_z=True, z_channels=4, resolution=32, in_channels=3, out_ch=3, ch=16,
              ch_mult=[1, 2, 2], num_res_blocks=1, attn_resolutions=[32, 16], dropout=0.0)
    x = np.random.default_rng(5).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    pvae = draw(AutoencoderKL(embed_dim=4, ddconfig=dd))
    sd = pvae.state_dict()
    assert "encoder.down.1.attn.0.q.weight" in sd and "encoder.down.2.attn.0.q.weight" not in sd
    params = to_jax(pvae, convert.vae_map("n", (), dd["ch_mult"], dd["num_res_blocks"]))
    jvae = JAutoencoderKL(embed_dim=4, ddconfig=dd)
    with torch.no_grad():
        z = pvae.encode(torch.from_numpy(x))
        check(z.numpy(), jvae.apply({"params": params}, x, method=jvae.encode), NET_TOL,
              "vae encode")
        check(pvae.decode(z).numpy(),
              jvae.apply({"params": params}, z.numpy(), method=jvae.decode), NET_TOL,
              "vae decode")


TEMPORAL = {
    "Upsample1D": (lambda: jvt.Upsample1D(num_frames=4), lambda: pvt.Upsample1D(16, num_frames=4),
                   (16, 6, 10, 16)),
    "Downsample1D": (lambda: jvt.Downsample1D(num_frames=4),
                     lambda: pvt.Downsample1D(16, num_frames=4), (4, 6, 10, 16)),
    "Downsample1D_pool": (lambda: jvt.Downsample1D(with_conv=False, num_frames=4),
                          lambda: pvt.Downsample1D(16, with_conv=False, num_frames=4),
                          (4, 6, 10, 16)),
    "ResnetBlock1D": (lambda: jvt.ResnetBlock1D(out_channels=24, num_frames=4),
                      lambda: pvt.ResnetBlock1D(16, 24, num_frames=4), (8, 6, 10, 24)),
    "ResnetBlock1D_conv": (lambda: jvt.ResnetBlock1D(out_channels=24, use_conv_shortcut=True,
                                                     num_frames=4),
                           lambda: pvt.ResnetBlock1D(16, 24, True, num_frames=4), (8, 6, 10, 24)),
    "ResnetBlock3D": (lambda: jvt.ResnetBlock3D(out_channels=24),
                      lambda: pvt.ResnetBlock3D(16, 24), (8, 6, 10, 24)),
    "ResnetBlock3D_conv": (lambda: jvt.ResnetBlock3D(out_channels=24, use_conv_shortcut=True),
                           lambda: pvt.ResnetBlock3D(16, 24, True), (8, 6, 10, 24)),
    "AttnBlockTemporal": (lambda: jvt.AttnBlockTemporal(num_frames=4),
                          lambda: pvt.AttnBlockTemporal(16, num_frames=4), (8, 6, 10, 16)),
}


@pytest.mark.parametrize("name", sorted(TEMPORAL))
def test_temporal_vae_blocks_match_jax(name):
    """tests/test_vae_temporal.py's input: (2 clips x 4 frames, 6, 10, 16)."""
    make_j, make_p, shape = TEMPORAL[name]
    x = np.random.RandomState(0).randn(8, 6, 10, 16).astype(np.float32)
    jblk = make_j()
    pblk = draw(make_p())
    params = to_jax(pblk, convert.vae_temporal_map("n", (), type(pblk).__name__))
    with torch.no_grad():
        got = pblk(torch.from_numpy(x)).numpy()
    assert got.shape == shape
    check(got, jblk.apply({"params": params}, x), NET_TOL, name)


def test_engine_passes_the_vector_condition_per_clip(monkeypatch):
    """``cond['vector']`` reaches the network as y, per clip, through CFG
    (uc rows first) and log_images' cut, on a stage-1 engine whose networks
    take a sequential vector from ConcatTimestepEmbedderND."""
    from panacea_tpu_torch.registry import instantiate_from_config

    cfg = copy.deepcopy(configs.TINY_STAGE1["model"])
    net = cfg["params"]["network_config"]["params"]
    for p in (net, net["controlnet_config"]["params"]):
        p.update(num_classes="sequential", adm_in_channels=256)
    cfg["params"]["conditioner_config"]["params"]["emb_models"].append(
        {"input_key": "original_size", "target":
         "sgm.modules.encoders.modules.ConcatTimestepEmbedderND", "params": {"outdim": 128}})
    eng = instantiate_from_config(cfg, device="cpu")
    eng.init_weights(torch.Generator().manual_seed(0), zero_init_std=0.02)
    seen = []
    real = eng.model.diffusion_model.forward
    monkeypatch.setattr(eng.model.diffusion_model, "forward",
                        lambda *a, y=None, **kw: seen.append(y) or real(*a, y=y, **kw))
    rng = np.random.default_rng(6)
    batch = {"jpg": rng.uniform(-1, 1, (2, 1, IH, IW, 3)).astype(np.float32),
             "cond_img": rng.uniform(0, 1, (2, 1, IH, IW, 19)).astype(np.float32),
             "final_cond_zero": np.zeros((2, 1, IH, IW, 3), np.float32),
             "txt": ["a street", "a road"],
             "original_size": np.array([[256, 512], [128, 64]], np.float32)}
    log = eng.log_images(batch, N=1, generator=torch.Generator().manual_seed(0), num_steps=1)
    assert log["samples"].shape == (1, IH, IW, 3) and torch.isfinite(log["samples"]).all()
    y = seen[0]
    want = eng.conditioner.embedders[-1](torch.tensor([[256.0, 512.0]]))
    assert y.shape == (2, 256)                         # [uc; c] for the one clip kept
    assert torch.equal(y[0], want[0]) and torch.equal(y[1], want[0])
