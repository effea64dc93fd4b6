"""One clip over several ranks (``inference_torch.py --view_shard V``,
``parallel/shardctx.py``) against one process, on the CPU over gloo.

Three grids, each one ``torchrun`` launch of ``tests/torch_dist_worker.py
--view_shard_checks`` (torch and BLAS on two threads a rank): 2 ranks at
(t 2, V 1), 2 at (t 1, V 2) and 4 at (t 2, V 2). In every rank
``tests/torch_view_shard_checks.py`` holds each sharded piece against the
one-process result on the same seeded inputs, fp32 (Conv2d at stride 1
and 2 and at the panorama's ends, GroupNorm, TemporalGroupNorm,
TemporalConv, the temporal stage, SpatialTemporalTransformer and its
'full' mode), then the 8-frame tiny engine's ``log_images``, its
``sample`` with injected conditioning and noise, Euler with churn and its
trajectory, and a two-window rollout; then the same launch runs
the tiny inference CLI with ``--view_shard V`` (``scripts/dist_rank.py
inference_view_shard``). Tolerances: each piece's largest difference from
one process within 1e-5 of the one-process result's largest value; the
CLI's files the same as one process's and every rank's latents within
1e-5 of its largest latent; the grid's latents against the JAX engine's
on the same weights and noise at ``tests/test_torch_engine.py``'s 1e-3.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_parity import to_jax, two_threads  # noqa: F401
from torch_view_shard_checks import (ENGINE_T, STEPS, engine_config, engine_inputs,
                                     tiny_engine)

from panacea_tpu.config import load_config
from panacea_tpu.registry import instantiate_from_config as jax_instantiate
from panacea_tpu_torch import convert, inference
from panacea_tpu_torch.models.engine import DiffusionEngine3D
from panacea_tpu_torch.parallel import comm_report, mesh, shardctx

pytestmark = pytest.mark.usefixtures("two_threads")
ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
JAX_CFG = os.path.join(ROOT, "panacea_tpu", "configs", "tiny_cpu.yaml")
TORCHRUN_VARS = mesh.RENDEZVOUS_VARS + ("LOCAL_WORLD_SIZE", mesh.BACKEND_VAR)
TOL, JAX_ATOL = 1e-5, 1e-3
# (processes, V): t = processes / V
GRIDS = [(2, 1), (2, 2), (4, 2)]
PIECES = ["conv_stride1", "conv_stride2", "conv_ends", "groupnorm", "temporal_groupnorm",
          "temporal_conv", "temporal_stage", "spatial_temporal_transformer",
          "full_mode_transformer"]
CLI = ["--synthetic", "--tiny", "--device", "cpu", "--num_batches", "1", "--name", "vs"]


def rank_reports(text: str) -> dict:
    decoder, out = json.JSONDecoder(), {}
    for line in text.splitlines():
        at = line.find('{"rank_report"')
        if at >= 0:
            rec = decoder.raw_decode(line[at:])[0]["rank_report"]
            out[rec["rank"]] = rec
    return out


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """The launch of each grid, on first use: {"checks", "reports", "dir"}."""
    done = {}

    def get(world, view):
        if (world, view) not in done:
            d = tmp_path_factory.mktemp(f"grid{world}x{view}")
            env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
            env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2")
            run = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", str(world), WORKER, "--view_shard_checks", str(d),
                 "inference_view_shard", "--dump", str(d / "ranks"), "--"]
                + CLI + ["--view_shard", str(view), "--outdir", str(d / "out")],
                cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
            assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
            checks = {}
            for r in range(world):
                with open(d / f"checks_rank{r}.json") as f:
                    checks[r] = json.load(f)
            done[(world, view)] = {"checks": checks, "reports": rank_reports(run.stdout),
                                   "dir": d}
        return done[(world, view)]

    return get


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The tiny CLI as one process: its output tree and sampled latents."""
    d = tmp_path_factory.mktemp("one")
    sampled = []
    sample = DiffusionEngine3D.sample

    def recorded(self, *a, **kw):
        out = sample(self, *a, **kw)
        sampled.append(out.detach().float())
        return out

    DiffusionEngine3D.sample = recorded
    try:
        inference.main(CLI + ["--outdir", str(d)])
    finally:
        DiffusionEngine3D.sample = sample
    return {"dir": d, "latents": sampled}


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# ------------------------------------------------------------- the pieces


@pytest.mark.parametrize("piece", PIECES)
@pytest.mark.parametrize("world, view", GRIDS)
def test_sharded_piece_matches_one_process(grids, world, view, piece):
    checks = grids(world, view)["checks"]
    errs = [checks[r][piece] for r in range(world)]
    assert max(errs) <= TOL, errs
    if piece == "conv_ends":
        # the ranks at the panorama's two ends held them
        assert sum(checks[r]["conv_ends_columns"] for r in range(world)) == 2 * (world // view)


@pytest.mark.parametrize("world, view", GRIDS)
def test_ranks_lie_as_the_jax_mesh(grids, world, view):
    """Rank r holds frame slab r // V and view slab r % V (JAX
    ``make_mesh(n, dp=1, view=V)``'s device order)."""
    checks = grids(world, view)["checks"]
    for r in range(world):
        assert checks[r]["grid"] == {"t": world // view, "view": view, "t_index": r // view,
                                     "view_index": r % view}


@pytest.mark.parametrize("world, view", GRIDS)
def test_log_images_matches_one_process(grids, world, view):
    """The 8-frame tiny engine's samples and reconstructions over the grid,
    gathered on every rank, against one process's."""
    checks = grids(world, view)["checks"]
    for r in range(world):
        for k in ("log_images_samples", "log_images_reconstructions"):
            assert checks[r][k] <= TOL, (r, k, checks[r][k])


@pytest.mark.parametrize("world, view", GRIDS)
def test_injected_sample_matches_one_process(grids, world, view):
    checks = grids(world, view)["checks"]
    assert max(checks[r]["sample_injected"] for r in range(world)) <= TOL


@pytest.mark.parametrize("world, view", GRIDS)
def test_sampler_draws_match_one_process(grids, world, view):
    """Euler with churn draws a step's noise at the clip's full shape from
    the generator and each rank keeps its slab: the trajectory, gathered
    step by step, is one process's."""
    checks = grids(world, view)["checks"]
    assert max(checks[r]["sample_churn_trajectory"] for r in range(world)) <= TOL


@pytest.mark.parametrize("world, view", GRIDS)
def test_rollout_matches_one_process(grids, world, view):
    """Two windows through ``rollout``: every rank conditions the second on
    the first's last frame, gathered, as one process does."""
    checks = grids(world, view)["checks"]
    assert max(checks[r]["rollout_frames"] for r in range(world)) <= TOL


@pytest.mark.parametrize("world, view", GRIDS)
def test_exchanges_follow_the_grid(grids, world, view):
    """Frames over t: halos in time, temporal statistics and the
    all-to-all; views over V: column halos, view statistics and the ring.
    Nothing else is exchanged a denoiser evaluation, and the clip's
    gathers run once."""
    ex = grids(world, view)["checks"][0]["exchanges"]
    t = world // view
    want = set()
    if t > 1:
        want |= {"halo_t", "stats_t", "all_to_all"}
    if view > 1:
        want |= {"halo_w", "stats_view", "ring"}
    assert ex["evals"] == STEPS   # log_images's
    assert set(ex["per_eval"]) == want
    assert "gather" in ex["once"] and all(r["MiB"] > 0 for r in ex["per_eval"].values())
    # the tiny UNet (7) and ControlNet (3) transformers, a cross-view ring each
    if view > 1:
        assert ex["per_eval"]["ring"]["calls"] == 10


def test_grid_sample_matches_jax(grids):
    """The (t 2, V 2) grid's latents from injected conditioning and noise
    against the JAX engine's, its weights carried from the port's tiny
    engine, 2 steps."""
    got = torch.load(grids(4, 2)["dir"] / "sample.pt")["latents"].numpy()
    eng = tiny_engine()
    net = engine_config()["params"]["network_config"]["params"]
    kw = dict(model_channels=net["model_channels"], channel_mult=net["channel_mult"],
              num_res_blocks=net["num_res_blocks"],
              attention_resolutions=net["attention_resolutions"])
    mapping = dict(convert.unet_map("model.diffusion_model", ("model", "unet"), **kw))
    mapping.update(convert.controlnet_map("model.diffusion_model.controlnet",
                                          ("model", "controlnet"), **kw))
    carried = [k for k in eng.state_dict() if not k.startswith("model.")]
    params = to_jax(eng, mapping, prefix="", carried=carried)
    cfg = load_config(JAX_CFG)["model"]
    jnet = cfg["params"]["network_config"]["params"]
    jnet["num_frames"] = jnet["controlnet_config"]["params"]["num_frames"] = ENGINE_T
    jeng = jax_instantiate(cfg)
    jeng.params = {"model": params["model"]}
    _, cond, uc, noise = engine_inputs()
    want = jeng.sample(jax.tree.map(jax.numpy.asarray, cond),
                       uc=jax.tree.map(jax.numpy.asarray, uc), batch_size=ENGINE_T,
                       shape=tuple(noise.shape[1:]), noise=jax.numpy.asarray(noise),
                       num_steps=STEPS)
    np.testing.assert_allclose(got, np.asarray(want), atol=JAX_ATOL, rtol=0)


# ------------------------------------------------------------------ the CLI


@pytest.mark.parametrize("world, view", GRIDS)
def test_cli_writes_what_one_process_writes(grids, one_process, world, view):
    """``--view_shard V`` under torchrun: rank 0 writes the files one process
    writes, and every rank's latents are one process's."""
    run = grids(world, view)
    assert tree(run["dir"] / "out") == tree(one_process["dir"])
    assert len(tree(one_process["dir"])) > 4
    reports = run["reports"]
    assert sorted(reports) == list(range(world))
    want = one_process["latents"]
    for r, rep in reports.items():
        assert rep["clips"] == 1 and rep["jax_modules"] == [], rep
        assert rep["grid"]["t"] == world // view and rep["grid"]["view"] == view
        assert rep["grid"]["host_staged"] is False
        assert rep["exchanges"]["evals"] > 0
        got = torch.load(run["dir"] / "ranks" / f"rank{r}.pt")["latents"]
        assert len(got) == len(want) == 1
        scale = want[0].abs().max().item()
        assert (got[0] - want[0]).abs().max().item() <= TOL * scale, r


# ---------------------------------------------------------------- the rules


@pytest.mark.parametrize("view, world", [(4, 4), (5, 5)])
def test_view_must_divide_6(view, world):
    with pytest.raises(SystemExit, match=f"--view_shard {view} must divide 6 and the process"):
        mesh.check_view_shard(view, world)


@pytest.mark.parametrize("view, world", [(2, 3), (3, 4), (6, 4)])
def test_view_must_divide_the_process_count(view, world):
    with pytest.raises(SystemExit, match=rf"process count \({world}\)"):
        mesh.check_view_shard(view, world)


def test_t_must_divide_the_frames():
    """6 ranks at V 2 give t 3 for 8 frames: refused, naming the sizes."""
    assert mesh.check_view_shard(2, 6) == 3
    with pytest.raises(SystemExit, match="t = 3 frame ranks do not divide the clip's 8 frames"):
        mesh.check_frames(3, 8)
    mesh.check_frames(4, 8)
    eng = tiny_engine()
    fake = mesh.Grid(0, 6, 3, 2, 0, 0, (0, 2, 4), (0, 1), None, None, "gloo", False)
    with pytest.raises(SystemExit, match="do not divide"):
        eng.set_grid(fake)
    assert eng.grid is None


def test_one_process_is_the_plain_path(tmp_path):
    """A grid of one rank is the identity: ``--view_shard 1`` with one
    process runs the plain path, and ``--view_shard 2`` refuses before
    writing anything."""
    assert mesh.make_grid(1, 1) is None
    assert shardctx.current() is None
    comm_report.reset()
    out = inference.main(CLI + ["--view_shard", "1", "--outdir", str(tmp_path / "one"),
                                "--num_steps", "1"])
    assert out["grid"] is None and out["done"] == 1
    assert comm_report.summary()["evals"] == 0
    with pytest.raises(SystemExit, match=r"must divide 6 and the process count \(1\)"):
        inference.main(CLI + ["--view_shard", "2", "--outdir", str(tmp_path / "two")])
    assert not os.path.exists(tmp_path / "two")


def test_widths_must_split_into_views():
    """A level of the panorama that does not split into 6 whole views over
    the view ranks is refused."""
    eng = tiny_engine()
    fake = mesh.Grid(0, 2, 1, 2, 0, 0, (0,), (0, 1), None, None, "gloo", False)
    eng.set_grid(fake)
    with pytest.raises(ValueError, match="does not split into 6 views"):
        eng._check_widths(42, None)   # 42 / 2 = 21 at the second level
    eng._check_widths(48, 384)


def test_no_context_leaves_the_layers_as_they_are():
    """Under ``sharded(None)`` a layer computes bit for bit what it computes
    outside any context."""
    from panacea_tpu_torch.models.layers import Conv2d, TemporalConv

    torch.manual_seed(0)
    x = torch.randn(4, 3, 12, 8)
    for m in (Conv2d(8, 8, 3, padding=1), TemporalConv(8, 2)):
        with torch.no_grad():
            want = m(x)
            with shardctx.sharded(None):
                assert torch.equal(m(x), want)
