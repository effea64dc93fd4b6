"""The port's ring cross-view attention (``parallel/ring_attention.py``)
against the JAX ``ring_cross_view_attention`` on the same numpy inputs.

The port's side runs on 6 gloo CPU ranks (``tests/torch_dist_worker.py
--ring_checks``, torch and BLAS on two threads each): at V in {1, 2, 3, 6}
each rank holds 6 / V views and exchanges its boundary views' K/V with its
neighbours. The JAX side runs on the 8-device CPU mesh of
``tests/conftest.py`` at the shapes of ``tests/test_ring_attention.py``,
with both of its ``impl`` values. Tolerance: atol 2e-5, as that test's.
"""

import importlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch_parity import two_threads  # noqa: F401
from torch_view_shard_checks import RING_SHAPE, RING_VIEWS, ring_inputs

from panacea_tpu.parallel.ring_attention import ring_cross_view_attention as jax_ring
from panacea_tpu_torch.parallel import mesh
from panacea_tpu_torch.parallel.ring_attention import ring_cross_view_attention

pytestmark = pytest.mark.usefixtures("two_threads")
ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
TORCHRUN_VARS = mesh.RENDEZVOUS_VARS + ("LOCAL_WORLD_SIZE", mesh.BACKEND_VAR)
ATOL = 2e-5


@pytest.fixture(scope="module")
def port_rings(tmp_path_factory):
    """{(V, last_view_left_only): (V, B, S, H, D)} assembled from the 6 ranks'
    slabs (the ranks of frame slab 0)."""
    out_dir = tmp_path_factory.mktemp("ring")
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2")
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "6", WORKER, "--ring_checks", str(out_dir)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    ranks = [torch.load(out_dir / f"ring_rank{r}.pt", weights_only=False) for r in range(6)]
    rings = {}
    for key in ranks[0]:
        parts = sorted((r[key]["view_index"], r[key]["out"]) for r in ranks
                       if r[key]["t_index"] == 0)
        assert [p[0] for p in parts] == list(range(key[0]))
        rings[key] = np.concatenate([p[1] for p in parts])
    return rings


@pytest.mark.parametrize("impl", ["partial", "ragged"])
@pytest.mark.parametrize("last_view_left_only", [True, False])
@pytest.mark.parametrize("view", RING_VIEWS)
def test_ring_matches_jax(port_rings, view, last_view_left_only, impl):
    q, k, v = ring_inputs()
    jmesh = Mesh(np.array(jax.devices()[:view]), ("view",))
    fn = jax.jit(lambda a, b, c: jax_ring(a, b, c, jmesh,
                                          last_view_left_only=last_view_left_only, impl=impl))
    want = np.asarray(fn(q, k, v))
    got = port_rings[(view, last_view_left_only)]
    assert got.shape == want.shape == RING_SHAPE
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ring_without_a_grid_is_the_one_rank_ring(port_rings):
    """grid None (one process holding the 6 views) computes what the ranks do."""
    q, k, v = (torch.from_numpy(a).transpose(0, 1) for a in ring_inputs())
    for quirk in (True, False):
        got = ring_cross_view_attention(q, k, v, None, last_view_left_only=quirk)
        np.testing.assert_allclose(got.transpose(0, 1).numpy(), port_rings[(1, quirk)],
                                   atol=ATOL, rtol=0)


def test_ring_call_takes_the_flash_route(monkeypatch):
    """At S >= 128 the ring's one call reaches the flash kernel's wrapper
    with per-row kv_lens: 2 S, and S for the global last view."""
    A = importlib.import_module("panacea_tpu_torch.ops.attention")
    calls = []
    real = A.flash_attention

    def recorded(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["kv_lens"].tolist()))
        return real(q, k, v, **kw)

    monkeypatch.setattr(A, "flash_attention", recorded)
    q, k, v = (torch.randn(2, 6, 128, 1, 16) for _ in range(3))
    ring_cross_view_attention(q, k, v, None)
    assert calls == [((12, 128, 1, 16), (12, 256, 1, 16), [256] * 5 + [128] + [256] * 5 + [128])]
