"""The port's VAE training losses (``panacea_tpu_torch/losses``) against the
JAX package's, on the CPU.

Every parameter is drawn on the port's side (``torch_parity.draw``: weights
at 1/sqrt(fan-in), biases and norm offsets nonzero) and carried to the JAX
modules through ``convert``'s maps walked backwards. LPIPS runs at the full
VGG16 width. Tolerances, stated per test, are those of fp32 on both sides in
another order of summation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import check, draw, to_jax, two_threads  # noqa: F401

from panacea_tpu.diffusion.loss import StandardDiffusionLoss as JStandardDiffusionLoss
from panacea_tpu.losses import lpips as jlpips
from panacea_tpu.losses import vae_losses as jloss
from panacea_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from panacea_tpu_torch import convert
from panacea_tpu_torch.diffusion.loss import StandardDiffusionLoss
from panacea_tpu_torch.losses import vae_losses as ploss
from panacea_tpu_torch.losses.lpips import LPIPS
from panacea_tpu_torch.models.vae import AutoencoderKL
from panacea_tpu_torch.registry import instantiate_from_config

DD = {"double_z": True, "z_channels": 4, "resolution": 32, "in_channels": 3, "out_ch": 3,
      "ch": 16, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": []}
TINY_VAE = {"target": "sgm.models.autoencoder.AutoencoderKL",
            "params": {"embed_dim": 4, "ddconfig": DD}}
SIGMA = {"target": "sgm.modules.diffusionmodules.sigma_sampling.DiscreteSampling",
         "params": {"num_idx": 1000, "discretization_config": {
             "target": "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization"}}}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


@pytest.fixture(scope="module")
def lpips_pair():
    """The port's LPIPS with drawn weights, and the JAX LPIPS on the same
    weights as a function of NHWC arrays."""
    port = draw(LPIPS(), seed=1)
    params = to_jax(port, convert.lpips_map("n"))
    jmod = jlpips.LPIPS()
    run = jax.jit(lambda x, y: jmod.apply({"params": params}, x, y))
    return port, run


def images(seed, n, hw):
    return np.random.default_rng(seed).uniform(-1, 1, (n,) + hw + (3,)).astype(np.float32)


def test_lpips_matches_jax_at_full_vgg_width(lpips_pair, two_threads):
    """Two 32 x 32 pairs: within 1e-5 of the largest distance; zero for
    identical inputs."""
    port, run = lpips_pair
    x, y = images(2, 2, (32, 32)), images(3, 2, (32, 32))
    with torch.no_grad():
        got = port(nchw(x), nchw(y))
        same = port(nchw(x), nchw(x))
    assert got.shape == (2, 1, 1, 1)
    check(got.reshape(2, 1).numpy(), run(x, y), 1e-5, "lpips")
    assert float(same.abs().max()) == 0.0


def test_discriminator_matches_jax(two_threads):
    """The PatchGAN at ndf 64, 3 layers, on two 64 x 64 images: the patch
    logits within 1e-5 of their largest value."""
    port = draw(ploss.NLayerDiscriminator(ndf=64, n_layers=3), seed=4)
    params = to_jax(port, convert.nlayer_discriminator_map("n", (), 3))
    x = images(5, 2, (64, 64))
    with torch.no_grad():
        got = port(nchw(x))
    want = jloss.NLayerDiscriminator(ndf=64, n_layers=3).apply({"params": params}, x)
    assert got.shape == (2, 1, 6, 6)
    check(got.permute(0, 2, 3, 1).numpy(), want, 1e-5, "discriminator")


def test_loss_functions_match_jax():
    """The KL (logvar past both clips), hinge, vanilla and the adaptive
    weight (past its cap): within 1e-6 relative."""
    rng = np.random.default_rng(6)
    mean = rng.standard_normal((3, 4, 5, 5)).astype(np.float32)
    logvar = rng.uniform(-40, 25, (3, 4, 5, 5)).astype(np.float32)
    real, fake = (rng.standard_normal((3, 1, 6, 6)).astype(np.float32) * 2 for _ in range(2))
    t = torch.from_numpy
    check(ploss.kl_divergence(t(mean), t(logvar)).numpy(),
          jloss.kl_divergence(mean, logvar), 1e-6, "kl")
    for name in ("hinge_d_loss", "vanilla_d_loss"):
        check(getattr(ploss, name)(t(real), t(fake)).numpy(),
              getattr(jloss, name)(real, fake), 1e-6, name)
    for nll, g in ((3.0, 0.5), (1e3, 1e-6), (0.0, 2.0)):
        np.testing.assert_allclose(
            ploss.adaptive_weight(torch.tensor(nll), torch.tensor(g)).numpy(),
            jloss.adaptive_weight(jnp.float32(nll), jnp.float32(g)), rtol=1e-6)


@pytest.mark.parametrize("case", ["perceptual_inputs_to_target", "elementwise_target_to_inputs"])
def test_latent_lpips_on_the_tiny_vae_matches_jax(lpips_pair, two_threads, case):
    """``LatentLPIPS`` with its decoder built from the tiny VAE's config
    through the registry (the encoder dropped) and LPIPS at full width:
    (a) latent, perceptual and input terms, the 32 x 32 inputs resized down
    to the 16 x 16 decode; (b) ``perceptual_weight`` 0, so the L2 term stays
    elementwise and the input term broadcasts over it, the decode resized up
    to 24 x 24. Loss and log within 1e-4 of their largest value:
    ``jax.image.resize``'s bicubic is up to 1.7e-5 off its exact value, the
    port's ``resize`` 2e-7 (ROADMAP Queue C)."""
    port_lpips, run = lpips_pair
    pvae = draw(AutoencoderKL(embed_dim=4, ddconfig=DD), seed=7)
    params = to_jax(pvae, convert.vae_map("n", (), DD["ch_mult"], DD["num_res_blocks"]))
    jvae = JAutoencoderKL(embed_dim=4, ddconfig=DD)
    jdecode = jax.jit(lambda z: jvae.apply({"params": params}, z, method=jvae.decode))
    if case == "perceptual_inputs_to_target":
        kw = dict(perceptual_weight=0.5, latent_weight=2.0, perceptual_weight_on_inputs=0.25,
                  scale_input_to_tgt_size=True)
        img_hw = (32, 32)
    else:
        kw = dict(perceptual_weight=0.0, perceptual_weight_on_inputs=1.0,
                  scale_tgt_to_input_size=True)
        img_hw = (24, 24)
    port = ploss.LatentLPIPS(decoder_config=TINY_VAE, lpips_apply=port_lpips, **kw)
    assert not hasattr(port.decoder, "encoder")
    port.decoder.load_state_dict({k: v for k, v in pvae.state_dict().items()
                                  if not k.startswith("encoder.")}, strict=True)
    rng = np.random.default_rng(8)
    z_in, z_pred = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    img = images(9, 2, img_hw)
    jfn = jloss.LatentLPIPS(decode_apply=jdecode, lpips_apply=run, **kw)
    want, wlog = jfn(z_in, z_pred, image_inputs=img, split="val")
    with torch.no_grad():
        got, glog = port(nchw(z_in), nchw(z_pred), image_inputs=nchw(img), split="val")
    if case == "perceptual_inputs_to_target":
        assert got.ndim == 0
        check(got.numpy(), want, 1e-4, "loss")
    else:
        assert got.shape == (2, 4, 8, 8)
        check(got.permute(0, 2, 3, 1).numpy(), want, 1e-4, "elementwise loss")
    assert glog.keys() == wlog.keys()
    for k in wlog:
        check(glog[k].numpy(), wlog[k], 1e-4, k)


@pytest.mark.parametrize("step", [9, 10])
def test_lpips_with_discriminator_before_and_at_disc_start_matches_jax(lpips_pair, two_threads,
                                                                        step):
    """``GeneralLPIPSWithDiscriminator`` (disc_start 10, vanilla loss) one
    step before and at ``disc_start``: the generator's total and its terms
    and the discriminator's loss within 1e-5; both zero the adversarial
    terms before the start."""
    port_lpips, run = lpips_pair
    rng = np.random.default_rng(10)
    x, rec = images(11, 2, (32, 32)), images(12, 2, (32, 32))
    mean, logvar = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    real, fake = (rng.standard_normal((2, 3, 3, 1)).astype(np.float32) for _ in range(2))
    kw = dict(disc_start=10, kl_weight=1e-3, disc_weight=0.5, perceptual_weight=1.0,
              disc_loss="vanilla")
    jfn = jloss.GeneralLPIPSWithDiscriminator(lpips_apply=run, **kw)
    port = ploss.GeneralLPIPSWithDiscriminator(lpips_apply=port_lpips, **kw)
    want, wparts = jfn.generator_loss(x, rec, mean, logvar, fake, step, adaptive_w=0.7)
    wd = jfn.discriminator_loss(real, fake, step)
    with torch.no_grad():
        got, gparts = port.generator_loss(nchw(x), nchw(rec), nchw(mean), nchw(logvar),
                                          nchw(fake), step, adaptive_w=0.7)
        gd = port.discriminator_loss(nchw(real), nchw(fake), step)
    check(got.numpy(), want, 1e-5, "generator")
    for k in wparts:
        check(gparts[k].numpy(), wparts[k], 1e-5, k)
    if step < 10:
        assert float(gd) == 0.0 == float(wd)
    else:
        check(gd.numpy(), wd, 1e-5, "discriminator")


def test_the_five_registry_targets_instantiate():
    """The reference targets of the JAX registry's VAE-loss and data-module
    aliases build the port's classes."""
    data = {"target": "panacea_tpu_torch.data.nuscenes.dataset.NuScenesVideoDataset",
            "params": {"infos": [], "queue_length": 2}}
    built = {
        "sgm.modules.autoencoding.lpips.loss.lpips.LPIPS": {},
        "sgm.modules.autoencoding.lpips.model.model.NLayerDiscriminator": {"ndf": 8},
        "sgm.modules.autoencoding.losses.LatentLPIPS": {"decoder_config": TINY_VAE},
        "sgm.modules.autoencoding.losses.GeneralLPIPSWithDiscriminator": {"disc_start": 1},
        "sgm.data.dataset.DataModuleFromConfig": {"batch_size": 2, "train": data},
    }
    for target, params in built.items():
        obj = instantiate_from_config({"target": target, "params": params})
        assert type(obj).__module__.startswith("panacea_tpu_torch."), target
        assert type(obj).__name__ == target.rsplit(".", 1)[1]
    assert obj.num_workers == 4


def test_port_lpips_as_the_diffusion_loss_lpips_fn_matches_jax(lpips_pair, two_threads):
    """``StandardDiffusionLoss(type="lpips")`` with the port's LPIPS as
    ``lpips_fn`` (on the loss's channels-last tensors) against the JAX loss
    with the JAX LPIPS: the per-sample loss within 1e-5."""
    port_lpips, run = lpips_pair
    out, target = images(13, 2, (32, 32)), images(14, 2, (32, 32))
    w = np.ones((2, 1, 1, 1), np.float32)
    jfn = JStandardDiffusionLoss(SIGMA, type="lpips", lpips_fn=run)
    port = StandardDiffusionLoss(SIGMA, type="lpips", lpips_fn=lambda a, b: port_lpips(
        a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)))
    with torch.no_grad():
        got = port.get_loss(torch.from_numpy(out), torch.from_numpy(target), torch.from_numpy(w))
    want = jfn.get_loss(jnp.asarray(out), jnp.asarray(target), jnp.asarray(w))
    assert got.shape == (2,)
    check(got.numpy(), want, 1e-5, "lpips loss")
