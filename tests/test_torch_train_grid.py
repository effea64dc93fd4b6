"""Training one clip over several ranks (the JAX trainer's ``t`` axis,
``train_torch.py`` under torchrun with ``--dp`` below the process count) on
the CPU over gloo, against one process.

Two ``torchrun`` launches of ``tests/torch_dist_worker.py
--train_grid_checks`` (torch and BLAS on two threads a rank), each running
``tests/torch_train_grid_checks.py`` in every rank: 2 ranks (the exchanges
at t 2, the tiny step at t 2), then the tiny training CLI with no ``--dp``
(t 2) through ``scripts/dist_rank.py train --replay fp32``, and its resume
from ``iter_1`` in the same group; 4 ranks (the exchanges at t 4, the tiny
step at dp 2 x t 2).

Tolerances:
  * each exchange's backward (``halo_t``, ``group_stats`` over t, the
    temporal all-to-all in and out), float64: the sharded gradient within
    ``EXCHANGE_TOL`` of the one-process gradient's largest value; each
    planted fault at least ``FAULT_FACTOR`` times that;
  * the tiny step (4 frames, the zero-initialised layers drawn at 0.02,
    ``use_checkpoint`` on) against one process, PR 20's tolerances
    (``tests/test_torch_parallel_train.py``) where rounding allows them:
    the loss within 1e-5 relative; the trained gradients within 1e-5 of
    the whole gradient's norm, jointly and each parameter's; each
    parameter's gradient within ``OWN_TOL`` of its own norm. 1e-5 of its
    own norm is the rounding floor of any split of the batch: plain data
    parallelism of the same batch (one clip a rank, no exchange, recorded
    as ``plain_dp``) reads 1.0e-5 in ``none`` and 9.6e-6 in ``spatial``,
    the grid 1.34e-5 and 7.3e-6, a dropped halo gradient 0.62. Left out
    of that are the parameters whose one-process gradient is at rounding
    level (at most 1e-6 of the whole norm; they read 4e-9 to 8e-9 of it,
    the next smallest 1.9e-5): biases, and the time embedding's
    projections, that add a constant to each channel before a GroupNorm
    of one channel a group, so that their exact gradient is 0. They are
    named in the record and held over the whole norm. The AdamW update:
    within ``UPDATE_TOL`` of its norm over the elements whose one-process
    gradient exceeds 1e-5 of its largest element, and within
    ``UPDATE_ALL_TOL`` over every element. AdamW's first step moves every
    element by about lr times the sign of its gradient, whatever its size,
    so an element whose gradient is within rounding of 0 moves either
    way: the whole update reads 5.9e-4 (``none``) and 6.8e-4
    (``spatial``) from one process's over the grid, and 6.5e-4 and 6.3e-4
    for plain data parallelism. The elements left out of the first
    measure, 17.2 % in ``none`` (11.6 % with a gradient of exactly 0) and
    0.93 % in ``spatial``, are held under ``LEFT_OUT``. Every rank's
    parameters equal; the halo fault in the step at least
    ``FAULT_FACTOR`` times the gradient tolerance;
  * the CLI: its losses within 1e-5 relative and its trained parameters
    within 1e-5 of their norm of one process's; rank 0 alone writes; the
    resume equal to the uninterrupted run exactly; the fp32 replay's
    gradients over the grid within 1e-5 of rank 0's alone jointly and each
    parameter's within ``OWN_TOL`` of its own norm (it reads 1.5e-5), the
    fault at least ``FAULT_FACTOR`` times that.
"""

import ast
import contextlib
import json
import os

import pytest
import torch
from test_torch_guards import FORBIDDEN
from test_torch_parallel import WORKER, check_ranks, torchrun
from torch_parity import two_threads  # noqa: F401

from panacea_tpu_torch import train
from panacea_tpu_torch.models.engine import DiffusionEngine3D
from panacea_tpu_torch.parallel import mesh, shardctx

pytestmark = pytest.mark.usefixtures("two_threads")
ROOT = os.path.join(os.path.dirname(__file__), "..")
EXCHANGE_TOL, FAULT_FACTOR = 1e-6, 10.0
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-5, 1e-5, 1e-4
OWN_TOL, UPDATE_ALL_TOL = 5e-5, 2e-3
LEFT_OUT = {"none": 0.2, "spatial": 0.02}
ZERO_INIT_STD = 0.02
OPS = ["halo_t", "group_stats", "temporal_all_to_all"]
FREEZES = ["none", "spatial"]
# the tiny config at 4 frames, so that a rank of t 2 holds 2: at its own 2
# frames a rank holds one, and each temporal GroupNorm (one channel a
# group at the tiny widths) takes its statistics over two values, which
# amplifies rounding: the fp32 replay read 8.6e-5 there, 3.8e-6 at 4 frames
FRAMES = [f"model.params.network_config.params.{p}num_frames=4"
          for p in ("", "controlnet_config.params.")]
CLI = ["--tiny", "--synthetic", "--device", "cpu", "--bs", "1", "--steps", "2",
       "--freeze_type", "spatial", "--log_every", "1"] + FRAMES


def drawn_zero_init(init_weights):
    def init(self, generator, zero_init_std=0.0):
        return init_weights(self, generator, zero_init_std=ZERO_INIT_STD)

    return init


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Each grid's launch on first use, and one process of the CLI."""
    root = tmp_path_factory.mktemp("train_grid")
    done = {}

    def get(world):
        if world not in done:
            d = root / f"w{world}"
            if world == 2:
                reports = torchrun([WORKER, "--train_grid_checks", str(d), "--then_resume",
                                    "--record_saves", str(d / "saves"), "train", "--dump",
                                    str(d / "ranks"), "--replay", "fp32", "--zero_init_std",
                                    str(ZERO_INIT_STD), "--"]
                                   + CLI + ["--ckpt_every", "1", "--ckpt_dir", str(d / "two")],
                                   timeout=300)
            else:
                torchrun([WORKER, "--train_grid_checks", str(d)], nproc=world, timeout=300)
                reports = None
            checks = {}
            for r in range(world):
                with open(d / f"grid_rank{r}.json") as f:
                    checks[r] = json.load(f)
            done[world] = {"checks": checks, "reports": reports, "dir": d}
        return done[world]

    return get


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The CLI's run as one process, the same zero-initialised layers drawn."""
    d = tmp_path_factory.mktemp("one")
    init_weights = DiffusionEngine3D.init_weights
    DiffusionEngine3D.init_weights = drawn_zero_init(init_weights)
    try:
        out = train.main(CLI + ["--ckpt_every", "0", "--ckpt_dir", str(d)], save_final=False)
    finally:
        DiffusionEngine3D.init_weights = init_weights
    return out


# ------------------------------------------------------------- the exchanges


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", OPS)
def test_exchange_backward_matches_one_process(launches, world, op):
    """At t = 2 and 4 frame ranks each exchange's gradient is the
    one-process op's, sliced to the rank; its forward too, and its
    exchanges are counted forward and backward."""
    for r, c in launches(world)["checks"].items():
        rec = c["exchanges"][op]
        assert rec["grad"] <= EXCHANGE_TOL and rec["forward"] <= EXCHANGE_TOL, (r, rec)
        fwd = {"halo_t": "halo_t", "group_stats": "stats_t",
               "temporal_all_to_all": "all_to_all"}[op]
        assert rec["kinds"] == [fwd, fwd + "_bwd"], (r, rec)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", OPS)
def test_planted_exchange_fault_is_caught(launches, world, op):
    """The halo gradient dropped, the statistics' backward left local, the
    all-to-all's backward not inverted: each reads at least FAULT_FACTOR
    times the tolerance on every rank."""
    recs = [c["exchanges"][op] for c in launches(world)["checks"].values()]
    assert min(r["fault_grad"] for r in recs) >= FAULT_FACTOR * EXCHANGE_TOL, recs


# ------------------------------------------------------------- a training step


def check_grad(rec, trained):
    """A gradient's distance from one process's (``grad_rel`` and
    ``grad_distance`` records): jointly and the rounding-level parameters
    over the whole norm, each other parameter over its own."""
    assert rec["joint"] <= GRAD_TOL and rec["rounding_max"] <= GRAD_TOL, rec
    assert rec["max_param"] <= OWN_TOL, rec
    assert len(rec["rounding"]) < trained / 10, rec
    assert all(k.endswith((".bias", "emb_layers.1.weight")) for k in rec["rounding"]), rec


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("freeze", FREEZES)
def test_step_matches_one_process(launches, world, freeze):
    """One step of the 4-frame tiny engine at t 2 (2 ranks) and dp 2 x t 2
    (4 ranks), checkpointed blocks recomputed in the backward, against one
    process on the same global batch and draws."""
    checks = launches(world)["checks"]
    losses = set()
    for r, c in checks.items():
        grid, rec = c["steps"]["grid"], c["steps"][freeze]
        assert (grid["dp"], grid["t"]) == (world // 2, 2)
        assert (grid["dp_index"], grid["t_index"]) == divmod(r, 2)
        assert rec["loss_rel"] <= LOSS_TOL, rec
        check_grad(rec["grad"], rec["trained"])
        upd = rec["update"]
        assert upd["determined"] <= UPDATE_TOL and upd["all"] <= UPDATE_ALL_TOL, rec
        assert upd["left_out"] <= LEFT_OUT[freeze], rec
        if "plain_dp" in rec:      # the floor the tolerances stand on
            plain = rec["plain_dp"]
            check_grad(plain["grad"], rec["trained"])
            assert plain["update"]["all"] <= UPDATE_ALL_TOL, plain
        assert rec["ranks_same"], rec
        assert rec["steps"] == 1
        assert rec["exchanges"] == {"forward": ["all_to_all", "halo_t", "stats_t"],
                                    "recompute": ["all_to_all", "halo_t", "stats_t"],
                                    "backward": ["all_to_all_bwd", "halo_t_bwd",
                                                 "stats_t_bwd"]}, rec
        losses.add(rec["loss"])
    assert len(losses) == 1


@pytest.mark.parametrize("world", [2, 4])
def test_step_halo_fault_is_caught(launches, world):
    """The same step with the frame halo's gradient not sent back: its
    gradients at least FAULT_FACTOR times the tolerance from one process's."""
    for r, c in launches(world)["checks"].items():
        fault = c["steps"]["spatial"]["fault_halo_dropped_grad"]
        assert fault["joint"] >= FAULT_FACTOR * GRAD_TOL, (r, fault)


# ------------------------------------------------------------- the CLI


def test_cli_trains_over_t_by_default(launches, one_process):
    """``train_torch.py`` under torchrun on 2 processes with no --dp trains
    one clip's frames over both (dp 1, t 2), as the JAX CLI does on two
    devices; its losses and trained parameters are one process's."""
    run = launches(2)
    reports = run["reports"]
    check_ranks(reports)
    one = one_process["state"].params
    for r, rep in reports.items():
        assert rep["grid"] == {"dp": 1, "t": 2, "dp_index": 0, "t_index": r,
                               "host_staged": False}
        assert rep["slab"] == {"clips": [0, 1], "frames": [2 * r, 2 * r + 2]}
        ex = rep["exchanges"]
        assert ex["steps"] == 2 and ex["forward_total"]["calls"] > 0
        assert ex["recompute_total"]["calls"] > 0 and ex["backward_total"]["calls"] > 0
        assert set(ex["backward"]) == {"halo_t_bwd", "stats_t_bwd", "all_to_all_bwd"}
        for got, want in zip(rep["losses"], one_process["losses"]):
            assert abs(got - want) <= LOSS_TOL * abs(want)
    dumped = torch.load(run["dir"] / "ranks" / "rank0.pt")
    final = torch.load(run["dir"] / "two" / "final.pt")
    num = sum(float((final[k] - one[k].detach()).norm()) ** 2 for k in one)
    den = sum(float(one[k].detach().norm()) ** 2 for k in one)
    assert (num / den) ** 0.5 <= GRAD_TOL
    assert dumped["losses"] == reports[0]["losses"]


def test_cli_replay_holds_the_grid_to_rank0_alone(launches):
    """``dist_rank.py train --replay fp32``: the last step's trained
    gradients over the grid against rank 0 alone with the whole clip, and
    the planted halo fault."""
    rec = launches(2)["reports"][0]["against_one_process"]["fp32"]
    # the CLI's engine trains the step's parameter set (4 frames, spatial)
    check_grad(rec["grid"], launches(2)["checks"][0]["steps"]["spatial"]["trained"])
    assert rec["fault"]["joint"] >= FAULT_FACTOR * GRAD_TOL, rec
    assert (rec["clips"], rec["frames"]) == (1, 4)


def test_cli_rank0_alone_writes(launches):
    d = launches(2)["dir"]
    saves = {}
    for r in (0, 1):
        with open(d / "saves" / f"saves_rank{r}.json") as f:
            saves[r] = json.load(f)
    ckpt = str(d / "two") + os.sep
    assert [p for p in saves[1] if p.startswith(ckpt)] == []
    wrote = {os.path.relpath(p, d / "two") for p in saves[0] if p.startswith(ckpt)}
    assert {os.path.join("iter_1", "state.pt.tmp"), os.path.join("iter_2", "state.pt.tmp"),
            "final.pt", "engine_final.ckpt"} <= wrote


def test_cli_resumes_exactly_over_the_grid(launches):
    """From iter_1 on the same grid, the second step is the uninterrupted
    run's, bit for bit."""
    run = launches(2)
    final = torch.load(run["dir"] / "two" / "final.pt")
    for r in (0, 1):
        got = torch.load(run["dir"] / f"resumed_rank{r}.pt")
        assert got["losses"] == run["reports"][r]["losses"][1:]
        for k, v in got["params"].items():
            assert torch.equal(v, final[k]), k


class _FakeGroup:
    def __init__(self, world):
        self.world = world

    @contextlib.contextmanager
    def __call__(self, device=None):
        yield mesh.Group(0, self.world, None, torch.device("cpu"))


def test_t_must_divide_the_frames(monkeypatch, tmp_path):
    """3 processes for 4 frames: t 3, refused naming the sizes before
    anything is written."""
    monkeypatch.setattr(mesh, "process_group", _FakeGroup(3))
    with pytest.raises(SystemExit, match="t = 3 frame ranks .* divide the clip's 4 frames"):
        train.main(CLI + ["--ckpt_dir", str(tmp_path / "x")])
    assert not os.path.exists(tmp_path / "x")


# ------------------------------------------------------------- forward-only exchanges


@pytest.mark.parametrize("exchange", ["halo_w", "stats_view", "ring", "gather_view"])
def test_view_exchanges_refuse_gradients(exchange):
    """No JAX path trains over 'view': given a tensor that needs a gradient,
    each exchange of the view group raises before it sends anything."""
    grid = mesh.Grid(0, 2, 1, 2, 0, 0, (0,), (0, 1), None, None, "gloo", False)
    x = torch.randn(2, 2, 12, 4, requires_grad=True)
    calls = {"halo_w": lambda: shardctx.halo_w(x),
             "stats_view": lambda: shardctx.group_stats(x, (1, 3), "view", 1e-5),
             "ring": lambda: shardctx.ring_exchange(x, x),
             "gather_view": lambda: shardctx.gather_view(x, 2)}
    with shardctx.sharded(grid), pytest.raises(RuntimeError, match="has no backward pass"):
        calls[exchange]()


def test_dist_rank_imports_no_jax():
    """The rank script runs on the card's machine, which has no JAX."""
    path = os.path.join(ROOT, "scripts", "dist_rank.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert names and not [n for n in names if n.split(".")[0] in FORBIDDEN]


def test_grid_loss_needs_the_clips_conditioning_frame():
    """Under a grid with the shared-noise bias on, ``diffusion_loss``
    refuses to run without ``share_frame``: a rank's own last frame is not
    the clip's conditioning frame."""
    import torch_train_grid_checks as checks

    eng = checks.tiny_engine("spatial")
    eng.loss_fn.share_noise_level = 0.07
    eng.set_grid(mesh.Grid(0, 2, 2, 1, 0, 0, (0, 1), (0,), None, None, "gloo", False))
    z = torch.zeros(2, 2, 24, 4)
    with pytest.raises(ValueError, match="needs share_frame"):
        eng.diffusion_loss(z, {"concat": torch.zeros(2, 2, 24, 4)})
