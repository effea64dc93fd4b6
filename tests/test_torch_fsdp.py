"""The sharded training state (``train_torch.py --fsdp``, ZeRO-3 over the
whole ``dp x t`` grid) on the CPU over gloo, against JAX's leaf rule, the
replicated state and one process.

The layout is a pure function: the port's ``mesh.fsdp_layout`` against the
JAX ``fsdp_spec`` (and ``fsdp_sharding``'s ``min_size``) leaf for leaf, on
the tiny engine at ``min_size`` 64 and on the production shapes of
``tests/fixtures/panaceaplus_keys.json`` at N = 2, 4 and 8: the same leaves
split, the same elements a rank. Torch orders a convolution's and a linear
layer's dimensions as the reverse of flax's, and the JAX rule is given
those.

Two ``torchrun`` launches of ``tests/torch_dist_worker.py --fsdp_checks``
(torch and BLAS on two threads a rank) run ``tests/torch_fsdp_checks.py``:
2 ranks, the grids (dp 2, t 1) and (dp 1, t 2) and the CLI; 4 ranks, (dp
2, t 2). Tolerances:
  * the sharded step against the replicated step on the same grid, two
    steps of the 4-frame tiny engine (``none`` and ``spatial``, the EMA
    on, the clip acting): the losses, the masters, AdamW's moments and the
    EMA shadows within ``FSDP_TOL`` of the replicated run's norm (fp32).
    The reduce-scatter's sums are the all-reduce's at 2 ranks (the
    gradients of one step are bit-equal), but the clip's norm sums the
    slices' squares over the ranks in another order: one ulp of the norm
    moves the moments by 1e-7 in the first step, and the second step
    reads up to 1.8e-6;
  * each planted fault at least ``FAULT_FACTOR`` times ``FSDP_TOL`` in
    some part of the state: no reduce-scatter (the moments 0.66), and the
    replicated leaves counted N times in the clip's norm (the moments
    1.2e-3; AdamW's update hardly moves with the gradient's scale, so the
    masters read 2.3e-7);
  * against one process on the whole batch, the training grid's tolerances
    (``tests/test_torch_train_grid.py``: the loss within 1e-5 relative,
    the gradients within 1e-5 of their norm jointly and ``OWN_TOL`` each);
  * the state a rank measured on its tensors equal to the layout's count;
    at each unit's start no split leaf whole, and at most two units
    gathered at once;
  * the CLI: an ``iter_2`` written under ``--fsdp`` key for key within
    ``FSDP_TOL`` of the replicated run's; resumed under ``--fsdp`` from
    ``iter_1``, bit for bit the uninterrupted run; resumed as one process,
    within 1e-5 of its norm (the batch split differs); its
    ``engine_final.ckpt`` through ``inference_torch.py --ckpt
    --prefer_ema``; at the default 65,536 elements, 2 ranks within 1e-5 of
    one process.

The chain to JAX: the sharded step equals the replicated and the
one-process steps here; ``tests/test_torch_train.py`` holds one process to
JAX.
"""

import json
import os

import numpy as np
import pytest
import torch
from test_torch_parallel import WORKER, torchrun
from test_torch_train_grid import FAULT_FACTOR, FREEZES, LOSS_TOL, check_grad
from torch_parity import two_threads  # noqa: F401

from panacea_tpu_torch import checkpoint, inference, train
from panacea_tpu_torch.configs import TINY_CPU
from panacea_tpu_torch.parallel import mesh
from panacea_tpu_torch.registry import instantiate_from_config

pytestmark = pytest.mark.usefixtures("two_threads")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "panaceaplus_keys.json")
FSDP_TOL = 5e-6
CLI_TOL = 1e-5
GRIDS = ["2x1", "1x2", "2x2"]
PARTS = ("params", "mu", "nu", "ema")


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp")
    done = {}

    def get(world):
        if world not in done:
            d = root / f"w{world}"
            torchrun([WORKER, "--fsdp_checks", str(d)], nproc=world, timeout=400)
            done[world] = {"dir": d, "ranks": {
                r: json.loads((d / f"fsdp_rank{r}.json").read_text()) for r in range(world)}}
        return done[world]

    return get


def grid_records(launches, grid):
    run = launches(4 if grid == "2x2" else 2)
    return {r: c["grids"][grid] for r, c in run["ranks"].items()}


# ------------------------------------------------------------- the layout


def jax_layout(named_shapes, n, min_size):
    """name -> (split, elements a rank) by the JAX rule, on flax's order of
    each leaf's dimensions (the reverse of torch's)."""
    from panacea_tpu.parallel.mesh import fsdp_spec

    out = {}
    for name, shape in named_shapes.items():
        flax = tuple(reversed(tuple(shape)))
        size = int(np.prod(flax)) if flax else 1
        spec = () if size < min_size else tuple(fsdp_spec(flax, n, ("dp", "t")))
        split = any(s is not None for s in spec)
        out[name] = (split, size // n if split else size)
    return out


def port_layout(named_shapes, n, min_size):
    lay = mesh.fsdp_layout(named_shapes, n, min_size)
    out = {}
    for name, shape in named_shapes.items():
        size = int(np.prod(shape)) if len(shape) else 1
        dim = lay[name]
        if dim is not None:
            assert shape[dim] % n == 0 and shape[dim] == max(
                d for d in shape if d % n == 0)
        out[name] = (dim is not None, size // n if dim is not None else size)
    return out


@pytest.mark.parametrize("n", [2, 4, 8])
def test_layout_matches_jax_on_the_tiny_engine(n):
    eng = instantiate_from_config(TINY_CPU["model"], device="cpu")
    shapes = {f"{r}.{k}": tuple(p.shape) for r, m in (("model", eng.model), (
        "first_stage_model", eng.first_stage_model)) for k, p in m.named_parameters()}
    got, want = port_layout(shapes, n, 64), jax_layout(shapes, n, 64)
    assert got == want
    assert sum(s for s, _ in got.values()) > len(got) // 2


@pytest.mark.parametrize("n", [2, 4, 8])
def test_layout_matches_jax_on_the_production_shapes(n):
    with open(FIXTURE) as f:
        keys = json.load(f)
    shapes = {k: tuple(v) for k, v in keys.items()
              if k.startswith(("model.diffusion_model.", "first_stage_model."))}
    got, want = port_layout(shapes, n, 65536), jax_layout(shapes, n, 65536)
    assert got == want
    net = [k for k in got if k.startswith("model.") and got[k][0]]
    assert len(net) == 1033
    assert sum(int(np.prod(shapes[k])) for k in net) == 2_235_757_568


def test_production_state_bytes_shard_8x():
    """As ``tests/test_parallel.py::test_fsdp_production_state_bytes_shard_8x``,
    from the fixture: the network's fp32 parameters and AdamW's two moments
    a rank under the layout at N = 8 are below a sixth of the total."""
    with open(FIXTURE) as f:
        keys = json.load(f)
    shapes = {k: tuple(v) for k, v in keys.items() if k.startswith("model.diffusion_model.")}
    layout = port_layout(shapes, 8, 65536)
    total = 3 * 4 * sum(int(np.prod(s)) if s else 1 for s in shapes.values())
    per_rank = 3 * 4 * sum(n for _, n in layout.values())
    assert total > 10 * 2**30
    assert per_rank < total / 6, (per_rank / 2**30, total / 2**30)


# ------------------------------------------------------------- the step


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("freeze", FREEZES)
def test_sharded_step_matches_the_replicated_one(launches, grid, freeze):
    for r, rec in grid_records(launches, grid).items():
        got = rec[freeze]["vs_replicated"]
        assert got["loss"] <= FSDP_TOL and max(got[k] for k in PARTS) <= FSDP_TOL, (r, got)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("freeze", FREEZES)
def test_sharded_step_matches_one_process(launches, grid, freeze):
    for r, rec in grid_records(launches, grid).items():
        one = rec[freeze]["vs_one_process"]
        assert one["loss"] <= LOSS_TOL, (r, one)
        check_grad(one["grad"], rec[freeze]["trained"])


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("fault", ["no_reduce", "norm_n_times"])
def test_planted_faults_are_caught(launches, grid, fault):
    for r, rec in grid_records(launches, grid).items():
        got = rec["none"][f"fault_{fault}"]
        assert max(got[k] for k in PARTS) >= FAULT_FACTOR * FSDP_TOL, (r, got)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("freeze", FREEZES)
def test_resident_state_is_the_layouts(launches, grid, freeze):
    """A rank holds its slices and the replicated leaves, exactly as the
    layout counts them; between units no split leaf is whole."""
    for r, rec in grid_records(launches, grid).items():
        rec = rec[freeze]
        assert rec["split"] > 0
        assert rec["measured"] == rec["counted"], (r, rec["measured"], rec["counted"])
        assert rec["watch"]["whole_between"] == 0 and 1 <= rec["watch"]["max_gathered"] <= 2


# ------------------------------------------------------------- the CLI


def test_sharded_checkpoint_equals_the_replicated_one(launches):
    d = launches(2)["dir"]
    a = torch.load(d / "fsdp" / "iter_2" / "state.pt", weights_only=False)
    b = torch.load(d / "replicated" / "iter_2" / "state.pt", weights_only=False)
    assert sorted(a) == sorted(b) and a["step"] == b["step"] == 2
    pairs = {"params": (a["params"], b["params"]), "frozen": (a["frozen"], b["frozen"]),
             "mu": (a["optimizer"]["mu"], b["optimizer"]["mu"]),
             "nu": (a["optimizer"]["nu"], b["optimizer"]["nu"]),
             "ema": (a["ema"]["shadows"], b["ema"]["shadows"])}
    for name, (x, y) in pairs.items():
        assert sorted(x) == sorted(y), name
        assert all(x[k].shape == y[k].shape for k in y), name
        if y:
            num = sum(float((x[k].detach().double() - y[k].detach().double()).norm()) ** 2
                      for k in y)
            den = sum(float(y[k].detach().double().norm()) ** 2 for k in y)
            assert (num / den) ** 0.5 <= FSDP_TOL, name
    assert a["optimizer"]["count"] == b["optimizer"]["count"]


def test_sharded_resume_is_exact(launches):
    run = launches(2)
    d = run["dir"]
    got = torch.load(d / "fsdp_resumed.pt")
    final = torch.load(d / "fsdp" / "final.pt")
    assert got["losses"] == run["ranks"][0]["cli"]["losses"][1:]
    for k, v in got["params"].items():
        assert torch.equal(v, final[k]), k


def _dist(got, want):
    num = sum(float((got[k].double() - want[k].detach().double()).norm()) ** 2 for k in want)
    return (num / sum(float(want[k].detach().double().norm()) ** 2 for k in want)) ** 0.5


def test_sharded_checkpoint_resumes_as_one_process(launches, tmp_path):
    """The iter_1 that 2 ranks wrote under --fsdp, resumed by one process:
    its step is the sharded run's second (within the batch split's rounding)."""
    from torch_fsdp_checks import CLI

    run = launches(2)
    d = run["dir"]
    out = train.main(CLI + ["--ckpt_every", "0", "--ckpt_dir", str(tmp_path), "--resume",
                            str(d / "fsdp" / "iter_1")], save_final=False)
    want = run["ranks"][0]["cli"]["losses"][1:]
    assert abs(out["losses"][0] - want[0]) <= CLI_TOL * abs(want[0])
    final = torch.load(d / "fsdp" / "final.pt")
    assert _dist({k: final[k] for k in out["state"].params}, out["state"].params) <= CLI_TOL


def test_sharded_engine_checkpoint_loads_into_the_inference_cli(launches, tmp_path):
    from torch_fsdp_checks import FRAMES

    path = launches(2)["dir"] / "fsdp" / "engine_final.ckpt"
    sd = checkpoint.load_torch_checkpoint(str(path))
    final = torch.load(launches(2)["dir"] / "fsdp" / "final.pt")
    assert all(torch.equal(sd[k], final[k]) for k in final)
    inference.main(["--tiny", "--synthetic", "--device", "cpu", "--num_batches", "1",
                    "--num_steps", "1", "--ckpt", str(path), "--prefer_ema", "--outdir",
                    str(tmp_path)] + FRAMES)
    assert os.listdir(tmp_path)


def test_cli_at_the_default_min_size_matches_one_process(launches, tmp_path):
    """``torchrun --nproc_per_node 2 train_torch.py --tiny ... --fsdp`` at
    the default 65,536 elements (a few leaves of the tiny widths split):
    its losses and final masters are one process's."""
    from torch_fsdp_checks import CLI

    run = launches(2)
    cli = run["ranks"][0]["cli"]
    assert cli["default_split"] > 0
    one = train.main(CLI + ["--ckpt_every", "0", "--ckpt_dir", str(tmp_path)], save_final=False)
    for got, want in zip(cli["default_losses"], one["losses"]):
        assert abs(got - want) <= LOSS_TOL * abs(want)
    final = torch.load(run["dir"] / "default" / "final.pt")
    assert _dist({k: final[k] for k in one["state"].params}, one["state"].params) <= CLI_TOL


def test_clip_leaves_the_callers_gradients():
    """AdamW's clip scales copies: the sharded replay (``dist_rank.py``)
    steps twice on gradients that share tensors, and reads them after."""
    from panacea_tpu_torch.utils.optim import AdamW

    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(7, generator=g)}
    grads = {k: 10 * torch.randn(v.shape, generator=g) for k, v in params.items()}
    given = {k: v.clone() for k, v in grads.items()}
    assert AdamW(params, grad_clip=1.0).step(params, grads)["group0"] > 1.0
    assert all(torch.equal(grads[k], given[k]) for k in grads)
