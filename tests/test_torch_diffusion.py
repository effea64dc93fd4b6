"""The port's host-side pieces and diffusion math against the JAX package:
configs, registry, tokenizer, schedules, denoiser, CFG and the Euler-EDM
sampler loop (with a stub network and injected noise), panorama helpers."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from panacea_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from panacea_tpu.diffusion import util as jutil
from panacea_tpu.ops import panorama as jpano
from panacea_tpu.registry import instantiate_from_config as jax_instantiate
from panacea_tpu_torch import configs
from panacea_tpu_torch.data.tokenizer import SimpleTokenizer
from panacea_tpu_torch.diffusion import util
from panacea_tpu_torch.ops import panorama
from panacea_tpu_torch.registry import instantiate_from_config, resolve_target

CFG_DIR = os.path.join(os.path.dirname(__file__), "..", "panacea_tpu", "configs")


@pytest.mark.parametrize("name,fname", [("INFERENCE_NUSCENES", "inference_nuscenes.yaml"),
                                        ("TINY_CPU", "tiny_cpu.yaml")])
def test_configs_equal_the_yaml(name, fname):
    with open(os.path.join(CFG_DIR, fname)) as f:
        assert getattr(configs, name) == yaml.safe_load(f)


def test_registry_resolves_every_config_target_and_refuses_unknown():
    def targets(node):
        if isinstance(node, dict):
            if "target" in node:
                yield node["target"]
            for k, v in node.items():
                if k != "lossconfig":  # training only; the engine drops it
                    yield from targets(v)
        elif isinstance(node, list):
            for v in node:
                yield from targets(v)

    for cfg in (configs.INFERENCE_NUSCENES, configs.TINY_CPU):
        for t in targets(cfg["model"]):
            assert resolve_target(t).__module__.startswith("panacea_tpu_torch.")
    with pytest.raises(KeyError, match="no port"):
        resolve_target("torch.nn.Identity")


def test_tokenizer_hash_fallback_matches_jax():
    texts = ["a driving scene with cars", "", "Night. Rain, trucks & buses!" * 20]
    np.testing.assert_array_equal(SimpleTokenizer()(texts), JaxTokenizer()(texts))


def test_diffusion_utils_match_jax():
    ts = np.array([0, 1, 17, 999], np.int32)
    np.testing.assert_allclose(util.timestep_embedding(torch.from_numpy(ts), 33).numpy(),
                               np.asarray(jutil.timestep_embedding(jnp.asarray(ts), 33)),
                               atol=1e-4, rtol=0)  # fp32 args up to 999: ~1 ulp of exp/sin apart
    for legacy in (True, False):
        np.testing.assert_array_equal(util.sincos_1d_embedding(8, 64, legacy),
                                      jutil.sincos_1d_embedding(8, 64, legacy))
    np.testing.assert_array_equal(util.make_beta_schedule("linear", 1000, 1e-4, 2e-2),
                                  jutil.make_beta_schedule("linear", 1000, 1e-4, 2e-2))


def _engine_parts(cfg, instantiate):
    p = cfg["model"]["params"]
    return instantiate(p["denoiser_config"]), instantiate(p["sampler_config"])


def test_denoiser_and_schedule_match_jax():
    den, smp = _engine_parts(configs.INFERENCE_NUSCENES, instantiate_from_config)
    jden, jsmp = _engine_parts(configs.INFERENCE_NUSCENES, jax_instantiate)
    np.testing.assert_array_equal(smp.get_sigmas_np(25), jsmp.get_sigmas_np(25))
    np.testing.assert_array_equal(den.sigmas_np, np.asarray(jden.sigmas))
    sigma = np.array([14.6, 3.3, 0.03, 0.7], np.float32)
    np.testing.assert_array_equal(den.sigma_to_idx(torch.from_numpy(sigma)).numpy(),
                                  np.asarray(jden.sigma_to_idx(jnp.asarray(sigma))))


def test_sampler_trajectory_matches_jax_with_a_stub_network():
    """A fixed nonlinear stub network, the same noise and conditioning: the
    port's Python loop and the JAX lax.scan give the same per-step latents."""
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 3, 5, 4)).astype(np.float32)
    cond = rng.standard_normal((4, 7, 4)).astype(np.float32)
    uc = np.zeros_like(cond)

    def tnet(x, c_noise, c):
        t = c_noise.float().reshape(-1, 1, 1, 1) / 1000.0
        return torch.tanh(x) * (1 + t) + c["crossattn"].mean(dim=(1, 2)).reshape(-1, 1, 1, 1)

    def jnet(x, c_noise, c):
        t = c_noise.astype(jnp.float32).reshape(-1, 1, 1, 1) / 1000.0
        return jnp.tanh(x) * (1 + t) + c["crossattn"].mean(axis=(1, 2)).reshape(-1, 1, 1, 1)

    den, smp = _engine_parts(configs.TINY_CPU, instantiate_from_config)
    jden, jsmp = _engine_parts(configs.TINY_CPU, jax_instantiate)
    _, traj = smp(lambda x, s, c: den(tnet, x, s, c), torch.from_numpy(x0),
                  {"crossattn": torch.from_numpy(cond)}, uc={"crossattn": torch.from_numpy(uc)},
                  num_steps=4, return_trajectory=True)
    _, jtraj = jsmp(lambda x, s, c: jden(jnet, x, s, c), jnp.asarray(x0),
                    {"crossattn": jnp.asarray(cond)}, uc={"crossattn": jnp.asarray(uc)},
                    num_steps=4, rng=jax.random.PRNGKey(0), return_trajectory=True)
    assert traj.shape == (4,) + x0.shape
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-4, rtol=1e-5)


def test_panorama_helpers_match_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 24, 5)).astype(np.float32)
    v = panorama.split_views(torch.from_numpy(x))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jpano.split_views(jnp.asarray(x))))
    np.testing.assert_array_equal(panorama.merge_views(v).numpy(), x)
    t = v.reshape(2, 6, -1, 5)
    np.testing.assert_array_equal(panorama.neighbor_kv(t).numpy(),
                                  np.asarray(jpano.neighbor_kv(jnp.asarray(t.numpy()))))
