"""The port's sgm diffusion math against the JAX package: every sampler (Heun,
Euler with churn, the ancestral ones, DPM++2M, LMS) on a toy denoiser with
the JAX draws injected, the EDM discretization, the scalings and
weightings, the guiders, the latent distributions, and the registry's
aliases of all of them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panacea_tpu.diffusion import distributions as jdist
from panacea_tpu.registry import instantiate_from_config as jax_instantiate
from panacea_tpu_torch.diffusion import distributions as dist
from panacea_tpu_torch.registry import instantiate_from_config, resolve_target

SGM = "sgm.modules.diffusionmodules"
EDM_DISC = {"target": f"{SGM}.discretizer.EDMDiscretization",
            "params": {"sigma_min": 0.03, "sigma_max": 14.0, "rho": 7.0}}
DDPM_DISC = {"target": f"{SGM}.discretizer.LegacyDDPMDiscretization"}
CFG = {"target": f"{SGM}.guiders.VanillaCFG",
       "params": {"scale": 2.5, "dyn_thresh_config": {
           "target": f"{SGM}.sampling_utils.NoDynamicThresholding"}}}
DENOISER = {"target": f"{SGM}.denoiser.Denoiser",
            "params": {"weighting_config": {"target": f"{SGM}.denoiser_weighting.EDMWeighting"},
                       "scaling_config": {"target": f"{SGM}.denoiser_scaling.EDMScaling"}}}
CHURN = {"s_churn": 2.0, "s_tmin": 0.1, "s_tmax": 10.0, "s_noise": 1.003}
STEPS = 5
# float32 loops whose products and sums differ in order: relative to the
# largest value of the result
TOL = 2e-5


def _toy_net(xp):
    """A fixed network of x, c_noise and the text conditioning, in numpy-like ops."""
    def net(x, c_noise, c):
        t = c_noise.reshape(-1, 1, 1, 1)
        return xp.tanh(x) * (1.0 + 0.1 * t) + c["crossattn"].mean((1, 2)).reshape(-1, 1, 1, 1)
    return net


def _run_both(name, params, disc=EDM_DISC, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((3, 4, 6, 2)).astype(np.float32)
    cond = rng.standard_normal((3, 5, 4)).astype(np.float32)
    uc = 0.5 * rng.standard_normal((3, 5, 4)).astype(np.float32)
    cfg = {"target": f"{SGM}.sampling.{name}",
           "params": dict(params, discretization_config=disc, guider_config=CFG,
                          num_steps=STEPS)}
    key = jax.random.PRNGKey(seed + 7)
    draws = np.stack([np.asarray(jax.random.normal(k, x0.shape, jnp.float32))
                      for k in jax.random.split(key, STEPS)])

    jden, jsmp = jax_instantiate(DENOISER), jax_instantiate(cfg)
    jnet = _toy_net(jnp)
    want = jsmp(lambda x, s, c: jden(lambda a, b, cc: jnet(a, b, cc), x, s, c),
                jnp.asarray(x0), {"crossattn": jnp.asarray(cond)},
                uc={"crossattn": jnp.asarray(uc)}, rng=key)

    den, smp = instantiate_from_config(DENOISER), instantiate_from_config(cfg)
    tnet = _toy_net(torch)
    got = smp(lambda x, s, c: den(tnet, x, s, c), torch.from_numpy(x0),
              {"crossattn": torch.from_numpy(cond)}, uc={"crossattn": torch.from_numpy(uc)},
              noise=draws)
    return got.numpy(), np.asarray(want), smp


@pytest.mark.parametrize("name,params,disc", [
    ("HeunEDMSampler", {}, EDM_DISC),
    ("HeunEDMSampler", CHURN, EDM_DISC),
    ("EulerEDMSampler", CHURN, DDPM_DISC),
    ("EulerAncestralSampler", {"eta": 0.6, "s_noise": 0.9}, DDPM_DISC),
    ("DPMPP2SAncestralSampler", {}, EDM_DISC),
    ("DPMPP2MSampler", {}, EDM_DISC),
    ("DPMPP2MSampler", {}, DDPM_DISC),
    ("LinearMultistepSampler", {}, EDM_DISC),
    ("LinearMultistepSampler", {"order": 2}, DDPM_DISC),
])
def test_sampler_matches_jax_with_injected_draws(name, params, disc):
    got, want, smp = _run_both(name, params, disc)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    if "s_churn" in params:   # the churn acted: some steps, not all
        g = smp._gammas(smp.get_sigmas_np())
        assert 0 < (g > 0).sum() < STEPS


def test_euler_without_churn_draws_nothing_and_churn_draws_from_the_generator():
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.standard_normal((2, 3, 4, 2)).astype(np.float32))
    cond = {"crossattn": torch.from_numpy(rng.standard_normal((2, 5, 4)).astype(np.float32))}
    den = instantiate_from_config(DENOISER)

    def run(params, gen):
        smp = instantiate_from_config({"target": f"{SGM}.sampling.EulerEDMSampler", "params": dict(
            params, discretization_config=EDM_DISC, guider_config=CFG, num_steps=STEPS)})
        return smp(lambda x, s, c: den(_toy_net(torch), x, s, c), x0, cond, generator=gen)

    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    run({}, gen)
    assert torch.equal(gen.get_state(), state)
    a = run(CHURN, torch.Generator().manual_seed(3))
    b = run(CHURN, torch.Generator().manual_seed(3))
    c = run(CHURN, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_lms_coefficients_match_jax():
    from panacea_tpu.diffusion.samplers import linear_multistep_coeff as jcoeff
    from panacea_tpu_torch.diffusion.samplers import linear_multistep_coeff

    t = np.asarray(jax_instantiate(EDM_DISC).get_sigmas(6), np.float64)
    for order, i, j in ((1, 0, 0), (2, 3, 1), (4, 4, 3), (4, 4, 0)):
        assert linear_multistep_coeff(order, t, i, j) == jcoeff(order, t, i, j)
    with pytest.raises(ValueError, match="too high"):
        linear_multistep_coeff(4, t, 1, 0)


def test_edm_discretization_matches_jax():
    for params in ({}, EDM_DISC["params"]):
        cfg = {"target": EDM_DISC["target"], "params": params}
        disc, jdisc = instantiate_from_config(cfg), jax_instantiate(cfg)
        for n in (1, 7, 25):
            np.testing.assert_array_equal(disc.get_sigmas(n), jdisc.get_sigmas(n))
        smp = instantiate_from_config({"target": f"{SGM}.sampling.DPMPP2MSampler",
                                       "params": {"discretization_config": cfg}})
        jsmp = jax_instantiate({"target": f"{SGM}.sampling.DPMPP2MSampler",
                                "params": {"discretization_config": cfg}})
        np.testing.assert_array_equal(smp.get_sigmas_np(9), jsmp.get_sigmas_np(9))


@pytest.mark.parametrize("kind,name,params", [
    ("denoiser_scaling", "EDMScaling", {}), ("denoiser_scaling", "EDMScaling",
                                             {"sigma_data": 1.3}),
    ("denoiser_scaling", "VScaling", {}), ("denoiser_scaling", "EpsScaling", {}),
    ("denoiser_weighting", "UnitWeighting", {}), ("denoiser_weighting", "EDMWeighting", {}),
    ("denoiser_weighting", "EDMWeighting", {"sigma_data": 0.7}),
    ("denoiser_weighting", "VWeighting", {}), ("denoiser_weighting", "EpsWeighting", {}),
])
def test_scalings_and_weightings_match_jax(kind, name, params):
    cfg = {"target": f"{SGM}.{kind}.{name}", "params": params}
    sigma = np.array([0.03, 0.5, 1.0, 7.3, 80.0], np.float32)
    got = instantiate_from_config(cfg)(torch.from_numpy(sigma))
    want = jax_instantiate(cfg)(jnp.asarray(sigma))
    for g, w in zip(*(v if isinstance(v, tuple) else (v,) for v in (got, want))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7, atol=0)


def test_denoisers_match_jax():
    """The base Denoiser (EDM scaling) and the production DiscreteDenoiser,
    with a toy network, against the JAX ones."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 3, 5, 2)).astype(np.float32)
    sigma = np.array([0.04, 0.7, 3.1, 14.0], np.float32)
    c = {"crossattn": rng.standard_normal((4, 5, 4)).astype(np.float32)}
    discrete = {"target": f"{SGM}.denoiser.DiscreteDenoiser", "params": {
        "num_idx": 1000, "discretization_config": DDPM_DISC,
        "weighting_config": {"target": f"{SGM}.denoiser_weighting.EpsWeighting"},
        "scaling_config": {"target": f"{SGM}.denoiser_scaling.EpsScaling"}}}
    for cfg in (DENOISER, discrete):
        den, jden = instantiate_from_config(cfg), jax_instantiate(cfg)
        got = den(_toy_net(torch), torch.from_numpy(x), torch.from_numpy(sigma),
                  {k: torch.from_numpy(v) for k, v in c.items()})
        want = jden(_toy_net(jnp), jnp.asarray(x), jnp.asarray(sigma),
                    {k: jnp.asarray(v) for k, v in c.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(den.w(torch.from_numpy(sigma)).numpy(),
                                   np.asarray(jden.w(jnp.asarray(sigma))), rtol=1e-6)


def test_guiders_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    s = np.array([0.5, 2.0], np.float32)
    c = {"crossattn": rng.standard_normal((2, 5, 4)).astype(np.float32),
         "other": rng.standard_normal((3,)).astype(np.float32)}
    uc = {k: v * 0.5 for k, v in c.items()}
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    jj = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    for cfg in (CFG, {"target": f"{SGM}.guiders.IdentityGuider"}):
        g, jg = instantiate_from_config(cfg), jax_instantiate(cfg)
        got = g.prepare_inputs(torch.from_numpy(x), torch.from_numpy(s), tt(c), tt(uc))
        want = jg.prepare_inputs(jnp.asarray(x), jnp.asarray(s), jj(c), jj(uc))
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert got[2].keys() == want[2].keys()
        for k in got[2]:
            np.testing.assert_array_equal(got[2][k].numpy(), np.asarray(want[2][k]))
        out = rng.standard_normal((got[0].shape[0], 3, 4)).astype(np.float32)
        np.testing.assert_allclose(g(torch.from_numpy(out), None).numpy(),
                                   np.asarray(jg(jnp.asarray(out), None)), rtol=1e-6, atol=1e-6)


def test_distributions_match_jax():
    rng = np.random.default_rng(4)
    moments = rng.standard_normal((3, 4, 5, 8)).astype(np.float32) * 2
    moments[0, 0, 0, 4:] = 40.0   # a log-variance past the clamp
    other = rng.standard_normal((3, 4, 5, 8)).astype(np.float32)
    sample = rng.standard_normal((3, 4, 5, 4)).astype(np.float32)
    p, jp = dist.DiagonalGaussianDistribution(torch.from_numpy(moments)), \
        jdist.DiagonalGaussianDistribution(jnp.asarray(moments))
    q, jq = dist.DiagonalGaussianDistribution(torch.from_numpy(other)), \
        jdist.DiagonalGaussianDistribution(jnp.asarray(other))

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-5)

    close(p.kl(), jp.kl())
    close(p.kl(q), jp.kl(jq))
    close(p.nll(torch.from_numpy(sample)), jp.nll(jnp.asarray(sample)))
    close(p.nll(torch.from_numpy(sample), dims=(1, 2)), jp.nll(jnp.asarray(sample), dims=(1, 2)))
    close(p.mode(), jp.mode())
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (3, 4, 5, 4), jnp.float32))
    close(p.sample(noise=torch.from_numpy(noise)), jp.sample(key))
    gen = torch.Generator().manual_seed(0)
    assert p.sample(gen).shape == (3, 4, 5, 4)
    args = [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(4)]
    close(dist.normal_kl(*map(torch.from_numpy, args)), jdist.normal_kl(*args))
    det = dist.DiagonalGaussianDistribution(torch.from_numpy(moments), deterministic=True)
    jdet = jdist.DiagonalGaussianDistribution(jnp.asarray(moments), deterministic=True)
    close(det.kl(), jdet.kl())
    close(det.nll(torch.from_numpy(sample)), jdet.nll(jnp.asarray(sample)))
    d = dist.DiracDistribution(torch.from_numpy(sample))
    assert d.sample() is d.mode() is d.value

    reg, jreg = dist.DiagonalGaussianRegularizer(), jdist.DiagonalGaussianRegularizer()
    z, log = reg(torch.from_numpy(moments), noise=torch.from_numpy(noise))
    jz, jlog = jreg(jnp.asarray(moments), rng=key)
    close(z, jz)
    close(log["kl_loss"], jlog["kl_loss"])
    z, _ = dist.DiagonalGaussianRegularizer(sample=False)(torch.from_numpy(moments))
    close(z, jp.mode())
    with pytest.raises(ValueError, match="needs a generator"):
        reg(torch.from_numpy(moments))


NEW_ALIASES = {
    f"{SGM}.denoiser.Denoiser": {"weighting_config": {
        "target": f"{SGM}.denoiser_weighting.UnitWeighting"}, "scaling_config": {
        "target": f"{SGM}.denoiser_scaling.VScaling"}},
    f"{SGM}.denoiser_weighting.UnitWeighting": {},
    f"{SGM}.denoiser_weighting.EDMWeighting": {"sigma_data": 0.5},
    f"{SGM}.denoiser_weighting.VWeighting": {},
    f"{SGM}.denoiser_scaling.EDMScaling": {},
    f"{SGM}.denoiser_scaling.VScaling": {},
    f"{SGM}.discretizer.EDMDiscretization": {},
    f"{SGM}.guiders.IdentityGuider": {},
    f"{SGM}.sampling_utils.NoDynamicThresholding": {},
    f"{SGM}.sampling.HeunEDMSampler": {"discretization_config": EDM_DISC, "s_churn": 1.0},
    f"{SGM}.sampling.EulerAncestralSampler": {"discretization_config": EDM_DISC, "eta": 0.5},
    f"{SGM}.sampling.DPMPP2SAncestralSampler": {"discretization_config": EDM_DISC},
    f"{SGM}.sampling.DPMPP2MSampler": {"discretization_config": EDM_DISC, "num_steps": 3},
    f"{SGM}.sampling.LinearMultistepSampler": {"discretization_config": EDM_DISC, "order": 3},
    "sgm.modules.distributions.distributions.DiagonalGaussianDistribution": {
        "parameters": np.zeros((1, 4), np.float32)},
    "sgm.modules.distributions.distributions.DiracDistribution": {"value": 1.0},
    "sgm.modules.autoencoding.regularizers.DiagonalGaussianRegularizer": {"sample": False},
}


@pytest.mark.parametrize("target", sorted(NEW_ALIASES))
def test_registry_instantiates_every_new_alias(target):
    params = dict(NEW_ALIASES[target])
    if "parameters" in params:
        tparams = {"parameters": torch.from_numpy(params["parameters"])}
    else:
        tparams = params
    obj = instantiate_from_config({"target": target, "params": tparams})
    jobj = jax_instantiate({"target": target, "params": params})
    assert type(obj).__module__.startswith("panacea_tpu_torch.diffusion.")
    assert type(obj).__name__ == type(jobj).__name__
    assert resolve_target(target) is type(obj)
