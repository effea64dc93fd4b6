"""The sharded training state (``--fsdp``), inside every rank of a gloo
group (``tests/torch_dist_worker.py --fsdp_checks DIR``).

``run(DIR)`` writes ``DIR/fsdp_rank{R}.json``. On 2 ranks the grids (dp 2,
t 1) and (dp 1, t 2), on 4 ranks (dp 2, t 2); on each, for
``freeze_type`` ``none`` and ``spatial``, with the EMA on and the clip's
limit at half the tiny gradient's norm (so that it acts), two
``train_step``s of the 4-frame tiny engine (zero-initialised layers drawn
at 0.02, ``use_checkpoint`` on) with the state split at ``MIN_SIZE``
elements (the tiny widths put most leaves under the CLI's 65,536), against
the same two steps with the state replicated on the same grid and against
one process on the whole batch (computed on every rank):

  * ``vs_replicated``: the loss of each step, and the masters, AdamW's
    moments and the EMA shadows after both (gathered whole), each as the
    distance over the replicated run's norm;
  * ``vs_one_process``: the losses, and the first step's reduced
    gradients (gathered whole) as ``dist_rank.grad_distance``;
  * the rank's state measured on its tensors and counted from the layout;
    the most units gathered at once during a step; at each unit's start,
    the split leaves then whole (none should be);
  * in ``none``, one step with each planted fault against the replicated
    step: no reduce-scatter (each rank keeps its own gradient slice), and
    the replicated leaves' squares summed over the ranks in the clip's
    norm (counted N times).

On 2 ranks, ``cli`` adds the training CLI under ``--fsdp`` (4 frames,
``--use_ema``, 2 steps, ``--ckpt_every 1``), the same CLI replicated, the
``--fsdp`` CLI resumed from its ``iter_1``, and the ``--fsdp`` CLI at its
default 65,536 elements; the checkpoints are left in DIR for the test to
read.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import torch
import torch_train_grid_checks as grid_checks

from panacea_tpu_torch import train
from panacea_tpu_torch.parallel import fsdp, mesh
from panacea_tpu_torch.parallel.fsdp import Shards, measured_bytes
from panacea_tpu_torch.train_step import init_train_state, train_step

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))
from dist_rank import grad_distance  # noqa: E402

MIN_SIZE = 64
STEPS = 2
LR = 1e-3
# the tiny config at 4 frames, as tests/test_torch_train_grid.py runs it
FRAMES = [f"model.params.network_config.params.{p}num_frames=4"
          for p in ("", "controlnet_config.params.")]
CLI = ["--tiny", "--synthetic", "--device", "cpu", "--bs", "2", "--steps", "2",
       "--use_ema", "--log_every", "1"] + FRAMES


def _no_reduce(shards, buf):
    return buf[shards.rank].clone()


def _norm_n_times(shards, sharded_sq, replicated_sq):
    return shards.all_reduce_sum(sharded_sq + replicated_sq, "fsdp_norm")


FAULTS = {"no_reduce": ("_reduce_scatter", _no_reduce),
          "norm_n_times": ("square_over_ranks", _norm_n_times)}


@contextlib.contextmanager
def planted(fault):
    if fault is None:
        yield
        return
    attr, fn = FAULTS[fault]
    sound = getattr(fsdp, attr)
    setattr(fsdp, attr, fn)
    try:
        yield
    finally:
        setattr(fsdp, attr, sound)


@contextlib.contextmanager
def watched(eng, rec):
    """Count the units gathered at once (``max_gathered``) and, at each
    unit's start, the split leaves that are whole (``whole_between``)."""
    shards = eng.shards
    if shards is None:
        yield
        return
    installed = fsdp.Unit.installed
    live = [0]

    @contextlib.contextmanager
    def counted(unit):
        whole = sum(tuple(leaf.module._parameters[leaf.attr].shape) == leaf.shape
                    for leaf in shards.leaves.values())
        rec["whole_between"] = max(rec.get("whole_between", 0), whole)
        with installed(unit):
            live[0] += 1
            rec["max_gathered"] = max(rec.get("max_gathered", 0), live[0])
            try:
                yield
            finally:
                live[0] -= 1

    fsdp.Unit.installed = counted
    try:
        yield
    finally:
        fsdp.Unit.installed = installed


def steps(freeze, batch, grid, rows, frames, split, clip, n=STEPS, fault=None):
    """``n`` steps of the tiny engine on this rank's ``rows`` and ``frames``
    over ``grid`` (None: no grid), its state split at MIN_SIZE where
    ``split``: the losses, the first step's gradients and the state
    after, whole, and the rank's bytes."""
    import torch.distributed as dist

    eng = grid_checks.tiny_engine(freeze)
    if split:
        Shards(eng, dist.get_rank(), dist.get_world_size(), "gloo", min_size=MIN_SIZE)
    eng.set_grid(grid)
    state = init_train_state(eng, lr=LR, grad_clip=clip, use_ema=True)
    seen, rec = {}, {}
    step = state.optimizer.step

    def recorded(params, grads):
        if not seen:
            seen.update({k: v.detach().clone() for k, v in grads.items()})
        return step(params, grads)

    state.optimizer.step = recorded
    losses = []
    with watched(eng, rec), planted(fault):
        for k in range(n):
            gen = torch.Generator().manual_seed(1 + k)
            with torch.no_grad():
                cond = eng.conditioner(batch, eng.device, generator=gen, apply_ucg=True)
                jpg, cond, draws = train.rank_rows(eng, batch, cond, gen, rows, frames)
            losses.append(float(train_step(eng, state, jpg, cond, **draws)))

    def whole(tensors):
        return dict(tensors) if eng.shards is None else eng.shards.full(dict(tensors),
                                                                       everywhere=True)

    out = {"losses": losses, "grads": whole(seen), "params": whole(state.params),
           "mu": whole(state.optimizer.mu), "nu": whole(state.optimizer.nu),
           "ema": whole(state.ema.shadows), "watch": rec,
           "measured": measured_bytes(state, eng)}
    if eng.shards is not None:
        out["counted"] = eng.shards.counted_bytes(list(state.params), 4, True)
        out["split"] = len(eng.shards.leaves)
    return out


def rel(got: dict, want: dict) -> float:
    num = sum(float((got[k].double() - w.double()).norm()) ** 2 for k, w in want.items())
    den = sum(float(w.double().norm()) ** 2 for w in want.values())
    return (num / den) ** 0.5


def against(got, want) -> dict:
    return {"loss": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
            **{k: rel(got[k], want[k]) for k in ("params", "mu", "nu", "ema")}}


def grid_cases(grid, dp, t, one: dict) -> dict:
    """Every case on one grid (None where dp x t is plain data parallelism)."""
    import torch.distributed as dist

    rank = dist.get_rank()
    d, i = divmod(rank, t)
    local, tl = grid_checks.STEP_CLIPS // dp, grid_checks.STEP_T // t
    rows, frames = slice(d * local, (d + 1) * local), slice(i * tl, (i + 1) * tl)
    batch = grid_checks.global_batch()
    out = {"dp": dp, "t": t}
    for freeze in ("none", "spatial"):
        ref, clip = one[freeze]
        rep = steps(freeze, batch, grid, rows, frames, False, clip)
        got = steps(freeze, batch, grid, rows, frames, True, clip)
        rec = {"vs_replicated": against(got, rep),
               "vs_one_process": {"loss": max(abs(a - b) / abs(b) for a, b in
                                              zip(got["losses"], ref["losses"])),
                                  "grad": grad_distance(got["grads"], ref["grads"])},
               "measured": got["measured"], "counted": got["counted"], "split": got["split"],
               "watch": got["watch"], "trained": len(ref["grads"]), "losses": got["losses"]}
        if freeze == "none":
            rep1 = steps(freeze, batch, grid, rows, frames, False, clip, n=1)
            for fault in FAULTS:
                bad = steps(freeze, batch, grid, rows, frames, True, clip, n=1, fault=fault)
                rec[f"fault_{fault}"] = against(bad, rep1)
        out[freeze] = rec
    return out


def one_process() -> dict:
    """Per freeze type: the two steps in one process on the whole batch,
    on every rank (its all-reduces of identical gradients change nothing;
    a step on one rank alone would leave the others out of them), and the
    clip's limit, half the first gradient's norm."""
    batch = grid_checks.global_batch()
    out = {}
    for freeze in ("none", "spatial"):
        first = steps(freeze, batch, None, slice(None), slice(None), False, None, n=1)
        clip = sum(float(g.double().norm()) ** 2 for g in first["grads"].values()) ** 0.5 / 2
        out[freeze] = (steps(freeze, batch, None, slice(None), slice(None), False, clip), clip)
    return out


def cli_cases(dump_dir: str) -> dict:
    """The CLI under --fsdp, replicated, and resumed under --fsdp; the
    resumed run's losses and trained parameters, whole, to
    ``fsdp_resumed.pt`` (rank 0)."""
    import torch.distributed as dist

    def run(name, extra, **kw):
        return train.main(CLI + ["--ckpt_dir", os.path.join(dump_dir, name)] + extra,
                          fsdp_min_size=MIN_SIZE, **kw)

    sharded = run("fsdp", ["--fsdp", "--ckpt_every", "1"])
    out = {"split": len(sharded["engine"].shards.leaves), "losses": sharded["losses"]}
    replicated = run("replicated", ["--ckpt_every", "1"])
    out["replicated_losses"] = replicated["losses"]
    resumed = run("resumed", ["--fsdp", "--ckpt_every", "0", "--resume",
                              os.path.join(dump_dir, "fsdp", "iter_1")], save_final=False)
    # the CLI as a user runs it: the default 65,536 elements
    default = train.main(CLI + ["--fsdp", "--ckpt_every", "0", "--ckpt_dir",
                                os.path.join(dump_dir, "default")])
    out["default_split"] = len(default["engine"].shards.leaves)
    out["default_losses"] = default["losses"]
    st = resumed["state"]
    params = st.shards.full(dict(st.params))
    if dist.get_rank() == 0:
        torch.save({"losses": resumed["losses"], "params": params},
                   os.path.join(dump_dir, "fsdp_resumed.pt"))
    return out


def run(dump_dir: str) -> None:
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    one = one_process()
    out = {"grids": {}}
    shapes = [(2, 1), (1, 2)] if world == 2 else [(2, 2)]
    for dp, t in shapes:
        grid = mesh.make_grid(world, 1, "cpu", dp=dp)
        out["grids"][f"{dp}x{t}"] = grid_cases(grid, dp, t, one)
    if world == 2:
        out["cli"] = cli_cases(dump_dir)
    os.makedirs(dump_dir, exist_ok=True)
    with open(os.path.join(dump_dir, f"fsdp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
