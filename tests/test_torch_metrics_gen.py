"""The port's generation metrics against the JAX package: InceptionV3 and I3D
on the same weights (the port's drawn state dict carried into the JAX towers
by the JAX package's own mappings), the way back
(``convert.inception_state_dict_from_jax`` / ``i3d_state_dict_from_jax``),
and the FID/FVD math on the same features."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panacea_tpu.metrics_gen import fid as jfid
from panacea_tpu.metrics_gen.i3d import I3D as JaxI3D
from panacea_tpu.metrics_gen.inception import InceptionV3 as JaxInceptionV3
from panacea_tpu.utils.convert import (build_i3d_mapping, build_inception_mapping,
                                       convert_state_dict)
from panacea_tpu_torch import convert
from panacea_tpu_torch.metrics_gen import fid
from panacea_tpu_torch.metrics_gen.eval import init_random
from panacea_tpu_torch.metrics_gen.i3d import I3D
from panacea_tpu_torch.metrics_gen.inception import InceptionV3

# the towers in fp32 on the CPU, both packages: each output's largest
# difference over its largest value
TOWER_TOL = 1e-4

TOWERS = {"inception": (InceptionV3, build_inception_mapping,
                        convert.inception_state_dict_from_jax),
          "i3d": (I3D, build_i3d_mapping, convert.i3d_state_dict_from_jax)}


@pytest.fixture(scope="module")
def towers():
    """name -> (port tower with every tensor drawn, its state dict, the JAX params)."""
    out = {}
    for seed, (name, (cls, mapping, _)) in enumerate(TOWERS.items()):
        model = cls().eval()
        init_random(model, torch.Generator().manual_seed(seed))
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        params, missing, unexpected = convert_state_dict(sd, mapping())
        assert not missing and not unexpected
        out[name] = (model, sd, params)
    return out


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def test_inception_matches_jax(towers):
    model, _, params = towers["inception"]
    x = np.random.RandomState(0).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    want = jax.jit(lambda p, v: JaxInceptionV3().apply({"params": p}, v))(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 2048)
    assert _rel(got, want) <= TOWER_TOL


def test_i3d_matches_jax_with_and_without_logits(towers):
    model, _, params = towers["i3d"]
    x = np.random.RandomState(1).uniform(-1, 1, (1, 8, 32, 32, 3)).astype(np.float32)
    feats, logits = jax.jit(lambda p, v: JaxI3D().apply({"params": p}, v, return_logits=True))(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        got_f, got_l = model(xt, return_logits=True)
        assert torch.equal(model(xt), got_f)
    assert got_f.shape == (1, 1024) and got_l.shape == (1, 400)
    assert _rel(got_f, feats) <= TOWER_TOL
    assert _rel(got_l, logits) <= TOWER_TOL


def test_i3d_refuses_fewer_than_8_frames(towers):
    with pytest.raises(ValueError, match=">= 8 frames, got 7"):
        towers["i3d"][0](torch.zeros(1, 3, 7, 32, 32))


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_state_dict_round_trip_through_the_jax_mapping(towers, name):
    """port -> build_*_mapping -> *_state_dict_from_jax is the identity,
    every name, shape and value."""
    _, sd, params = towers[name]
    back = TOWERS[name][2](params)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    # the JAX tree holds exactly the mapped leaves
    assert len(flax.traverse_util.flatten_dict(params)) == len(sd)


def _both(fn_name, *args):
    return getattr(fid, fn_name)(*args), getattr(jfid, fn_name)(*args)


def test_frechet_analytic_cases_match_jax():
    rs = np.random.RandomState(0)
    feats = rs.randn(500, 8)
    mu, cov = feats.mean(0), np.cov(feats, rowvar=False)
    for args, exact in (((mu, cov, mu, cov), 0.0),
                        ((np.zeros(4), np.eye(4), np.full(4, 0.5), np.eye(4)), 1.0),
                        ((np.array([1.0]), np.array([[4.0]]), np.array([2.0]),
                          np.array([[9.0]])), 2.0)):
        got, want = _both("frechet_distance", *args)
        scale = np.trace(args[1]) + np.trace(args[3])
        assert abs(got - want) <= 1e-8 * scale
        assert abs(got - exact) <= 1e-6 * scale


def test_streaming_stats_match_jax_and_numpy():
    feats = np.random.RandomState(1).randn(300, 6)
    port, jax_stats = fid.StreamingStats(6), jfid.StreamingStats(6)
    for i in range(0, 300, 50):
        port.update(torch.from_numpy(feats[i:i + 50]).float())
        jax_stats.update(feats[i:i + 50].astype(np.float32))
    (mu, cov), (jmu, jcov) = port.finalize(), jax_stats.finalize()
    assert port.sum.dtype == torch.float64 and port.n == 300
    np.testing.assert_allclose(mu, jmu, atol=1e-12)
    np.testing.assert_allclose(cov, jcov, atol=1e-10)
    np.testing.assert_allclose(cov, np.cov(feats.astype(np.float32), rowvar=False), atol=1e-10)
    with pytest.raises(ValueError, match="at least 2"):
        one = fid.StreamingStats(6)
        one.update(feats[:1])
        one.finalize()


def test_compute_fid_and_fvd_match_jax():
    rs = np.random.RandomState(2)
    real = [rs.randn(100, 5) for _ in range(3)]
    gen = [rs.randn(100, 5) + 0.3 * rs.randn(5) for _ in range(3)]
    for name in ("compute_fid", "compute_fvd"):
        got, want = getattr(fid, name)(real, gen), getattr(jfid, name)(real, gen)
        scale = sum(np.trace(np.cov(np.concatenate(b), rowvar=False)) for b in (real, gen))
        assert abs(got - want) <= 1e-8 * scale
    # features as tensors, as the CLI gives them
    got = fid.compute_fid(map(torch.from_numpy, real), map(torch.from_numpy, gen))
    assert abs(got - jfid.compute_fid(real, gen)) <= 1e-8 * scale
    assert fid.compute_fid(real, [b + 3.0 for b in real]) > 40


@pytest.mark.parametrize("failures", [1, 2, 3])
def test_eps_ladder_matches_jax(monkeypatch, failures):
    """The eigensolver failing on the first attempts: both packages retry
    with eps 1e-6 then 1e-3 on the same matrices, and give up after that."""
    rs = np.random.RandomState(3)
    f1, f2 = rs.randn(4, 16), rs.randn(4, 16) + 0.5   # rank-deficient covariances
    args = (f1.mean(0), np.cov(f1, rowvar=False), f2.mean(0), np.cov(f2, rowvar=False))
    eigh = np.linalg.eigh
    results = []
    for module in (fid, jfid):
        calls = []

        def failing(a, *rest, **kw):
            calls.append(a[0, 0])
            if len(calls) <= failures:
                raise np.linalg.LinAlgError("did not converge")
            return eigh(a, *rest, **kw)

        monkeypatch.setattr(np.linalg, "eigh", failing)
        if failures == 3:
            with pytest.raises(np.linalg.LinAlgError, match="eps=1e-3"):
                module.frechet_distance(*args)
        else:
            results.append((module.frechet_distance(*args), calls))
        monkeypatch.setattr(np.linalg, "eigh", eigh)
    if failures < 3:
        (got, calls), (want, jcalls) = results
        np.testing.assert_array_equal(calls, jcalls)   # the same regularised matrices
        assert calls[-1] == pytest.approx(args[1][0, 0] + (1e-6, 1e-3)[failures - 1])
        assert abs(got - want) <= 1e-8 * (np.trace(args[1]) + np.trace(args[3]))
