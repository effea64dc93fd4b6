"""The port's embedders against the JAX package's: the vector and class
embedders and the conditioner's routing (list outputs, the whole-batch
class embedder), the CLIP-L text tower with quick_gelu, the layer choice and
EOT pooling of FrozenOpenCLIPEmbedder2, the CLIP vision tower and image
embedder, ``jax.image.resize``, the image-space embedders (DownSampler,
SpatialRescaler, LowScaleEncoder, GaussianEncoder, the VAEEmbedder blur),
the T5 wrappers without local weights, and the registry.

Every parameter is drawn: the CLIP towers from the JAX init plus a random
offset, carried by ``convert.clip_state_dict_from_jax``; the other modules
on the port's side, carried to the JAX one by ``convert``'s maps walked
backwards (``torch_parity.to_jax``). The JAX draws (LowScaleEncoder's
noise level and noise, GaussianEncoder's sample) are injected into the
port. Networks agree within NET_TOL of the output's largest value;
embeddings, resizes and elementwise modules within ELEM_TOL.
"""

import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_keys_cubic_kernel, _fill_triangle_kernel
from jax._src.image.scale import compute_weight_mat
from torch_parity import check, draw, rel_err, to_jax, two_threads  # noqa: F401

from panacea_tpu.models import clip as jclip
from panacea_tpu.models import conditioner as jcond
from panacea_tpu.registry import _SGM_TO_LOCAL
from panacea_tpu_torch import convert
from panacea_tpu_torch.models import clip as pclip
from panacea_tpu_torch.models import conditioner as pcond
from panacea_tpu_torch.ops.resize import resize
from panacea_tpu_torch.registry import instantiate_from_config, resolve_target

pytestmark = pytest.mark.usefixtures("two_threads")
NET_TOL = 1e-4
ELEM_TOL = 1e-5
TEXTS = ["a driving scene with cars", "", "night. rain, trucks & buses"]
TINY_VAE = {"target": "sgm.models.autoencoder.AutoencoderKL",
            "params": {"embed_dim": 4, "ddconfig": {
                "double_z": True, "z_channels": 4, "resolution": 32, "in_channels": 3,
                "out_ch": 3, "ch": 16, "ch_mult": [1, 2], "num_res_blocks": 1,
                "attn_resolutions": []}}}


def offset(params, seed=0, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(p.shape).astype(np.float32), params)


def load_tower(module, params, layers, vision=False, prefix="m"):
    sd = convert.clip_state_dict_from_jax(params, prefix, layers, vision=vision)
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def jax_text_embedder(cls, seed=0, **kw):
    emb = cls(**kw)
    emb.params = offset(emb.init_params(jax.random.PRNGKey(seed)), seed)
    return emb


# ---------------------------------------------------------------- resize


def resize_exact(x, shape, kind, antialias=True):
    """jax.image.resize's separable product in float64, on jax's own fp32
    weight matrices."""
    kernel = {"cubic": _fill_keys_cubic_kernel, "linear": _fill_triangle_kernel}[kind]
    out = np.asarray(x, np.float64)
    for d, (m, n) in enumerate(zip(out.shape, shape)):
        if m != n:
            w = np.asarray(compute_weight_mat(m, n, n / m, 0.0, kernel, antialias), np.float64)
            out = np.moveaxis(np.tensordot(out, w, axes=([d], [0])), -1, d)
    return out


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic", "area"])
@pytest.mark.parametrize("shape", [(2, 6, 9, 3), (2, 31, 52, 3), (2, 13, 40, 3)],
                         ids=["down", "up", "mixed"])
@pytest.mark.parametrize("antialias", [True, False])
def test_resize_matches_jax_image_resize(method, shape, antialias):
    """Down (antialiased or not), up and one axis each way; 'area' reads as
    'linear', as the JAX embedders map it."""
    x = np.random.default_rng(0).standard_normal((2, 13, 29, 3)).astype(np.float32)
    jm = {"area": "linear"}.get(method, method)
    want = jax.image.resize(x, shape, jm, antialias=antialias)
    check(resize(torch.from_numpy(x), shape, method if method != "area" else "linear",
                 antialias).numpy(), want, ELEM_TOL, f"resize {method} {shape}")


def test_resize_is_not_interpolate():
    """jax's bicubic (Keys, a = -0.5, antialiased down) and its nearest
    (half-pixel centres) differ from F.interpolate's defaults."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 3, 16, 16)).astype(
        np.float32))
    nhwc = x.permute(0, 2, 3, 1)
    for method, mode in (("bicubic", "bicubic"), ("nearest", "nearest")):
        ours = resize(nhwc, (1, 7, 7, 3), method).permute(0, 3, 1, 2)
        theirs = torch.nn.functional.interpolate(x, size=(7, 7), mode=mode)
        assert (ours - theirs).abs().max() > 1e-2, method
    exact = torch.nn.functional.interpolate(x, size=(7, 7), mode="nearest-exact")
    assert torch.equal(resize(nhwc, (1, 7, 7, 3), "nearest").permute(0, 3, 1, 2), exact)


# ------------------------------------------------------ vector and class


def test_concat_timestep_embedder_matches_jax():
    x = np.array([[256, 512], [128, 1024], [0, 7]], np.float32)
    want = jcond.ConcatTimestepEmbedderND(outdim=64)(x)
    got = pcond.ConcatTimestepEmbedderND(outdim=64)(torch.from_numpy(x))
    assert got.shape == (3, 128)
    check(got.numpy(), want, ELEM_TOL, "concat timestep")
    check(pcond.ConcatTimestepEmbedderND(16)(torch.tensor([3.0, 9.0])).numpy(),
          jcond.ConcatTimestepEmbedderND(16)(np.array([3.0, 9.0])), ELEM_TOL, "1-D input")


def test_class_embedders_match_jax():
    table = np.random.default_rng(2).standard_normal((5, 8)).astype(np.float32)
    for add_seq in (False, True):
        j = jcond.ClassEmbedder(embed_dim=8, n_classes=5, add_sequence_dim=add_seq)
        j.params = jnp.asarray(table)
        p = pcond.ClassEmbedder(embed_dim=8, n_classes=5, add_sequence_dim=add_seq)
        p.embedding.weight.data = torch.from_numpy(table)
        c = np.array([4, 0, 2])
        check(p(c).detach().numpy(), j(c), ELEM_TOL, f"class add_seq={add_seq}")
    j = jcond.ClassEmbedderForMultiCond(embed_dim=8, n_classes=5)
    j.params = jnp.asarray(table)
    p = pcond.ClassEmbedderForMultiCond(embed_dim=8, n_classes=5)
    p.embedding.weight.data = torch.from_numpy(table)
    for v in ([np.array([1, 3])], np.array([2])):
        want, got = j({"cls": v, "other": 1}, key="cls"), p({"cls": v, "other": 1}, key="cls")
        assert isinstance(got["cls"], list) == isinstance(v, list) and got["other"] == 1
        w, g = (want["cls"][0], got["cls"][0]) if isinstance(v, list) else (want["cls"],
                                                                           got["cls"])
        check(g.detach().numpy(), w, ELEM_TOL, "multicond")


# ------------------------------------------------------------------ text


TINY_TEXT = dict(width=64, heads=4, layers=3, vocab_size=49408)


def test_clip_l_tower_matches_jax():
    """FrozenCLIPEmbedder: OpenAI's CLIP-L at its widths (768, 12 heads, 12
    layers, quick_gelu, the last layer); the tower carried with its packed
    in_proj."""
    j = jax_text_embedder(jclip.FrozenCLIPEmbedder)
    p = pclip.FrozenCLIPEmbedder()
    assert isinstance(p.model.transformer.resblocks[0].mlp.gelu, pclip.QuickGELU)
    load_tower(p.model, j.params, 12)
    with torch.no_grad():
        check(p(TEXTS).numpy(), j(TEXTS), NET_TOL, "clip-l")


@pytest.mark.parametrize("layer", ["last", "penultimate"])
def test_open_clip_embedder2_layer_and_pooling_match_jax(layer):
    kw = dict(layer=layer, always_return_pooled=True, **TINY_TEXT)
    j = jax_text_embedder(jcond.FrozenOpenCLIPEmbedder2, **kw)
    p = pcond.FrozenOpenCLIPEmbedder2(**kw)
    load_tower(p.model, j.params, TINY_TEXT["layers"])
    with pytest.raises(ValueError, match="text_projection"):
        p(TEXTS)
    proj = np.random.default_rng(3).standard_normal((64, 32)).astype(np.float32)
    sd = {"conditioner.embedders.1.model.text_projection": proj,
          "conditioner.embedders.0.model.text_projection": -proj}
    assert j.load_text_projection(sd, prefix="conditioner.embedders.0")
    assert p.load_text_projection(sd, prefix="conditioner.embedders.0")
    assert not p.load_text_projection({"x.ln_final.weight": proj[0]})
    jz, jpooled = j(TEXTS)
    with torch.no_grad():
        z, pooled = p(TEXTS)
    assert pooled.shape == (3, 32)
    check(z.numpy(), jz, NET_TOL, f"open_clip2 {layer} tokens")
    check(pooled.numpy(), jpooled, NET_TOL, f"open_clip2 {layer} pooled")


def test_eot_is_the_first_maximum_in_both():
    """The pooled token is the EOT (the largest id), found by argmax: jax
    and torch both return the first of equal maxima."""
    tokens = np.array([[49406, 320, 49407, 0, 0], [49406, 49407, 49407, 5, 0]], np.int32)
    assert list(np.asarray(jnp.argmax(jnp.asarray(tokens), axis=-1))) == [2, 1]
    assert torch.from_numpy(tokens).long().argmax(dim=-1).tolist() == [2, 1]


def test_conditioner_routes_lists_and_the_whole_batch_like_jax():
    """A tower returning (tokens, pooled) feeds 'crossattn' and 'vector';
    the whole-batch class embedder and a size embedder add to 'vector';
    the BEV layout goes to 'cond_feat'."""
    emb_models = [
        {"input_key": "txt", "target": "sgm.modules.encoders.modules.FrozenOpenCLIPEmbedder2",
         "params": dict(layer="penultimate", always_return_pooled=True, **TINY_TEXT)},
        {"input_key": "cls", "target": "sgm.modules.encoders.modules.ClassEmbedderForMultiCond",
         "params": {"embed_dim": 16, "n_classes": 5}},
        {"input_key": "original_size",
         "target": "sgm.modules.encoders.modules.ConcatTimestepEmbedderND",
         "params": {"outdim": 8}},
        {"input_key": "cond_img", "target": "sgm.modules.encoders.modules.IdentityEncoder"}]
    jc = jcond.GeneralConditioner(emb_models)
    pc = instantiate_from_config({"target": "sgm.modules.GeneralConditioner",
                                  "params": {"emb_models": emb_models}})
    rng = np.random.default_rng(4)
    text = jc.embedders[0]
    text.params = offset(text.init_params(jax.random.PRNGKey(0)))
    load_tower(pc.embedders[0].model, text.params, TINY_TEXT["layers"])
    sd = {"t.text_projection": rng.standard_normal((64, 32)).astype(np.float32)}
    text.load_text_projection(sd)
    pc.embedders[0].load_text_projection(sd)
    table = rng.standard_normal((5, 16)).astype(np.float32)
    jc.embedders[1].params = jnp.asarray(table)
    pc.embedders[1].embedding.weight.data = torch.from_numpy(table)
    batch = {"txt": TEXTS[:2], "cls": [np.array([4, 1])],
             "original_size": np.array([[256, 512], [64, 32]], np.float32),
             "cond_img": rng.uniform(0, 1, (2, 1, 8, 48, 19)).astype(np.float32)}
    want = jc(batch)
    with torch.no_grad():
        got = pc(batch, "cpu")
    assert sorted(got) == sorted(want) == ["cond_feat", "crossattn", "vector"]
    assert got["vector"].shape == (2, 32 + 16 + 16)
    for k in want:
        check(got[k].numpy(), want[k], NET_TOL, f"conditioner {k}")


# ---------------------------------------------------------------- vision


VISION = dict(width=64, heads=4, layers=2, output_dim=32)


def jax_vision_pair(seed=0):
    tower = jclip.CLIPVisionTransformer(**VISION)
    params = offset(tower.init(jax.random.PRNGKey(seed), jnp.zeros((1, 224, 224, 3)))["params"],
                    seed)
    ptower = load_tower(pclip.CLIPVisionTransformer(**VISION), params, VISION["layers"],
                        vision=True)
    return tower, params, ptower


def test_vision_tower_matches_jax():
    tower, params, ptower = jax_vision_pair()
    x = np.random.default_rng(5).standard_normal((2, 224, 224, 3)).astype(np.float32)
    pooled, tokens = tower.apply({"params": params}, x, output_tokens=True)
    with torch.no_grad():
        got_pooled, got_tokens = ptower(torch.from_numpy(x), output_tokens=True)
        assert torch.equal(ptower(torch.from_numpy(x)), got_pooled)
    assert got_tokens.shape == (2, 256, 64) and ptower.conv1.bias is None
    check(got_pooled.numpy(), pooled, NET_TOL, "vision pooled")
    check(got_tokens.numpy(), tokens, NET_TOL, "vision tokens")


@pytest.mark.parametrize("form", [{}, {"unsqueeze_dim": True}, {"repeat_to_max_len": True}])
def test_image_embedder_matches_jax(form):
    """The resize to 224 (bicubic, antialiased up or down), OpenAI's mean
    and std, and the output's shape options."""
    j = jclip.FrozenOpenCLIPImageEmbedder(**VISION, max_length=5, **form)
    _, j.params, ptower = jax_vision_pair()
    p = pclip.FrozenOpenCLIPImageEmbedder(**VISION, max_length=5, **form)
    p.model.visual.load_state_dict(ptower.state_dict())
    p.eval()
    mean, std = np.array(p.OPENAI_MEAN), np.array(p.OPENAI_STD)
    for hw in ((96, 160), (256, 300)):
        x = np.random.default_rng(6).uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
        got = p.preprocess(torch.from_numpy(x)).numpy()
        # jax.image.resize's bicubic is itself up to 1.7e-5 from its exact
        # value on the way up (fp32 products); the port's 2e-7. So the port
        # is held to the exact value, and to jax's within jax's own error
        exact = ((resize_exact(x, (2, 224, 224, 3), "cubic") + 1.0) / 2.0 - mean) / std
        want = np.asarray(j.preprocess(jnp.asarray(x)))
        check(got, exact, ELEM_TOL, f"preprocess {hw} vs exact")
        check(got, want, ELEM_TOL + rel_err(want, exact), f"preprocess {hw}")
        with torch.no_grad():
            got = p(x)
        want = j(x)
        assert got.shape == want.shape
        check(got.numpy(), want, NET_TOL, f"image embedder {form} {hw}")


# ----------------------------------------------------------- image space


def test_downsampler_matches_jax():
    p = draw(pcond.DownSampler(model_input_channels=4, in_channels=13))
    j = jcond.DownSampler(model_input_channels=4, in_channels=13)
    j.params = to_jax(p, convert.downsampler_map("n", ()))
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 96, 13)).astype(np.float32)
    with torch.no_grad():
        got = p(x)
    assert got.shape == (2, 8, 12, 4)
    check(got.numpy(), j(x), NET_TOL, "downsampler")


@pytest.mark.parametrize("kw", [dict(n_stages=2, method="bilinear", out_channels=8),
                                dict(n_stages=1, method="nearest"),
                                dict(n_stages=1, method="bicubic", multiplier=1.5,
                                     out_channels=5, bias=True, kernel_size=3),
                                dict(n_stages=1, method="area", wrap_video=True,
                                     remap_output=True)],
                         ids=["bilinear_remap", "nearest", "bicubic_up_k3", "area_video"])
def test_spatial_rescaler_matches_jax(kw):
    j = jcond.SpatialRescaler(in_channels=3, **kw)
    p = pcond.SpatialRescaler(in_channels=3, **kw)
    shape = (2, 3, 16, 24, 3) if kw.get("wrap_video") else (2, 16, 24, 3)
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    if hasattr(p, "channel_mapper"):
        draw(p)
        j.params = to_jax(p, {f"n.channel_mapper.{n}": (("channel_mapper", k), t)
                              for n, k, t in (("weight", "kernel", convert._conv2d),
                                              ("bias", "bias", convert._none))})
    with torch.no_grad():
        got = p(x)
    check(got.numpy(), j(x), ELEM_TOL, f"rescaler {kw}")


def test_vae_embedder_blur_returns_the_frames_as_jax():
    """down_blur_factor 2: the JAX blur resizes the frames to their own
    shape, so both encode them unchanged."""
    x = np.random.default_rng(9).uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    j = jcond.VAEEmbedder(down_blur_factor=2)
    j.encode_fn = lambda v: v
    p = pcond.VAEEmbedder(down_blur_factor=2)
    p.encode_fn = lambda v: v
    np.testing.assert_array_equal(np.asarray(j(x)), x)
    assert np.array_equal(p(torch.from_numpy(x)).numpy(), x)


def test_low_scale_encoder_matches_jax():
    """q_sample at the JAX draws (t from split key 2, the noise from key
    3), then a nearest resize to output_size."""
    j = jcond.LowScaleEncoder(TINY_VAE, 1e-4, 2e-2, output_size=8, max_noise_level=250,
                              scale_factor=0.3)
    p = pcond.LowScaleEncoder(TINY_VAE, 1e-4, 2e-2, output_size=8, max_noise_level=250,
                              scale_factor=0.3)
    draw(p.model)
    j.model_params = to_jax(p.model, convert.vae_map("n", (), [1, 2], 1))
    x = np.random.default_rng(10).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    z, t = j(x, rng=key)
    _, k2, k3 = jax.random.split(key, 3)
    t_draw = jax.random.randint(k2, (3,), 0, 250)
    noise = jax.random.normal(k3, (3, 16, 16, 4))
    with torch.no_grad():
        got, got_t = p(x, t=np.asarray(t_draw), noise=np.asarray(noise))
    assert got.shape == (3, 8, 8, 4) and got_t.tolist() == np.asarray(t).tolist()
    check(got.numpy(), z, NET_TOL, "low scale")
    with torch.no_grad():
        check(p.decode(got).numpy(), j.decode(z), NET_TOL, "low scale decode")
        assert p(x, generator=torch.Generator().manual_seed(0))[1].max() < 250


def test_gaussian_encoder_matches_jax():
    kw = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, resolution=16)
    j = jcond.GaussianEncoder(weight=0.5, **kw)
    p = draw(pcond.GaussianEncoder(weight=0.5, **kw))
    j.params = to_jax(p, convert.vae_encoder_map("", (), (1, 2), 1), prefix="")
    x = np.random.default_rng(11).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    log, z = j(x, rng=key)
    noise = jax.random.normal(jax.random.split(key)[1], (2, 8, 8, 4))
    with torch.no_grad():
        plog, pz = p(x, noise=np.asarray(noise))
    assert pz.shape == (2, 64, 4) and plog["weight"] == 0.5
    check(pz.numpy(), z, NET_TOL, "gaussian z")
    check(plog["kl_loss"].numpy(), log["kl_loss"], NET_TOL, "gaussian kl")
    assert float(plog["loss"]) == float(plog["kl_loss"])


# ----------------------------------------------------------- T5, registry


@pytest.mark.parametrize("name", ["FrozenT5Embedder", "FrozenByT5Embedder",
                                  "FrozenCLIPT5Encoder"])
def test_t5_wrappers_raise_without_local_weights(name, monkeypatch):
    """Without a local directory the first call names what is missing, and
    nothing reaches transformers or a socket first."""
    emb = instantiate_from_config({"target": f"sgm.modules.encoders.modules.{name}"})

    def no_network(*a, **kw):
        raise AssertionError("a network connection was attempted")

    monkeypatch.setattr(socket.socket, "connect", no_network)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(FileNotFoundError, match="no local weights for 'google/"):
        emb(["a street"])


def test_registry_resolves_every_sgm_target_of_the_jax_package():
    """Every sgm.* alias of panacea_tpu/registry.py resolves to the port,
    the VAE's training side and the data module included."""
    missing = set()
    for target in _SGM_TO_LOCAL:
        if not target.startswith("sgm."):
            continue
        try:
            assert resolve_target(target).__module__.startswith("panacea_tpu_torch.")
        except KeyError:
            missing.add(target)
    assert not missing, sorted(missing)
