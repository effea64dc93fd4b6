"""Training over the frame grid, inside every rank of a gloo group
(``tests/torch_dist_worker.py --train_grid_checks DIR``).

``run(DIR)`` writes ``DIR/grid_rank{R}.json``:

  * ``exchanges``: at t = world frame ranks (dp 1), the gradient of a
    random scalar function of each sharded op (``halo_t``,
    ``group_stats`` over t, ``temporal_in`` then ``temporal_out``) against
    the one-process op's gradient sliced to the rank, float64, as the
    largest difference over the one-process gradient's largest value; then
    the same with each planted fault (the halo gradient dropped, the
    statistics' backward left local, the all-to-all's backward not
    inverted), each set by replacing a backward here;
  * ``steps``: one ``train_step`` of the 4-frame tiny engine over the
    training grid (t 2, and dp = world / 2 clip groups), its zero-initialised
    layers drawn at 0.02 and ``use_checkpoint`` on, for ``freeze_type``
    ``none`` and ``spatial``, against the same step in one process computed
    on this rank: the loss, the trained parameters' gradients (the ranks'
    mean; jointly over the whole gradient's norm, and each parameter's
    over its own norm, those at rounding level named and held over the
    whole norm) and the AdamW update (over every element, and over the
    elements whose gradient is above rounding, with the share left out),
    each relative; whether every rank holds the same parameters after it;
    the step's exchanges by direction; in ``spatial`` the gradient with
    the halo fault planted; and on 2 ranks the same distances for plain
    data parallelism of the same batch (one clip a rank, no exchange:
    ``plain_dp``), the rounding floor that any split of the batch reads.

``resume(DIR, argv)`` runs the training CLI on ``argv`` in this group and
writes its losses and trained parameters to ``DIR/resumed_rank{R}.pt``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np
import torch

from panacea_tpu_torch import train
from panacea_tpu_torch.configs import TINY_CPU
from panacea_tpu_torch.data.nuscenes.dataset import NuScenesVideoDataset, collate
from panacea_tpu_torch.data.nuscenes.synthetic import make_synthetic_infos, synthetic_image_loader
from panacea_tpu_torch.parallel import comm_report, mesh, shardctx
from panacea_tpu_torch.parallel.train import assert_same
from panacea_tpu_torch.registry import instantiate_from_config
from panacea_tpu_torch.train_step import init_train_state, train_step

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))
from dist_rank import grad_distance  # noqa: E402  (the card's replay measures alike)

T, CLIPS = 8, 2               # the exchanges' frames and clips
HH, WW, C, GROUPS = 2, 4, 8, 4
EPS = 1e-5
STEP_T, STEP_CLIPS = 4, 2     # the tiny engine's frames; the global batch
FINAL_DIM = train.TINY_FINAL_DIM
ZERO_INIT_STD = 0.02
LR = 1e-3
GRAD_TOL = 1e-5


# ------------------------------------------------------------- exchanges


def _dropped_halo(ctx, gy):
    return gy.narrow(1, ctx.pad, gy.shape[1] - 2 * ctx.pad), None, None


def _local_stats(ctx, gy):
    return gy, None, None, None


def _not_inverted(ctx, gy):
    return gy, None


FAULTS = {"halo_dropped": (shardctx._HaloT, _dropped_halo),
          "stats_local": (shardctx._AllReduce, _local_stats),
          "all_to_all_not_inverted": (shardctx._AllToAll, _not_inverted)}


@contextlib.contextmanager
def planted(fault):
    """``fault``'s backward in place of the exchange's own."""
    if fault is None:
        yield
        return
    cls, backward = FAULTS[fault]
    sound = cls.backward
    cls.backward = staticmethod(backward)
    try:
        yield
    finally:
        cls.backward = sound


def scalar(y: torch.Tensor, w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A random function of ``y`` that is not linear."""
    return (w * y).sum() + 0.5 * (v * y * y).sum()


def _grad_err(g, full, full_fn, shard_fn, slab, out_slab, fault=None):
    """(sharded gradient's largest difference from the one-process one's
    slab) over the one-process gradient's largest value. ``full_fn``: the
    op on the whole tensor; ``shard_fn``: the op on this rank's slab under
    the grid; ``slab``/``out_slab`` cut the input/output to this rank."""
    rng = np.random.default_rng(7)
    x = full.clone().requires_grad_(True)
    y = full_fn(x)
    w, v = (torch.from_numpy(rng.standard_normal(y.shape)) for _ in range(2))
    # the function the ranks' outputs enter together: each rank's window of
    # the one-process output (windows of the halo overlap)
    total = sum(scalar(out_slab(y, r), out_slab(w, r), out_slab(v, r)) for r in range(g.t))
    (want,) = torch.autograd.grad(total, x)
    mine = slab(full, g.t_index).clone().requires_grad_(True)
    with shardctx.sharded(g), planted(fault):
        got = shard_fn(mine)
        scalar(got, out_slab(w, g.t_index), out_slab(v, g.t_index)).backward()
    fwd = float((got - out_slab(y, g.t_index)).detach().abs().max())
    return float((mine.grad - slab(want, g.t_index)).abs().max() / want.abs().max()), fwd


def exchange_cases(g) -> dict:
    rng = np.random.default_rng(3)
    tl = T // g.t
    out = {}

    def frames(x, r):            # (CLIPS, T, ...) -> rank r's frames
        return x[:, r * tl:(r + 1) * tl]

    # halo_t: the zero-padded clip's window of rank r, tl + 2 frames
    x = torch.from_numpy(rng.standard_normal((CLIPS, T, HH * WW, C)))
    cases = {"halo_t": (x, lambda z: torch.nn.functional.pad(z, (0, 0, 0, 0, 1, 1)),
                        lambda z: shardctx.halo_t(z), frames,
                        lambda y, r: y[:, r * tl:r * tl + tl + 2])}
    # the temporal GroupNorm's statistics over the frames and a channel group
    x = torch.from_numpy(rng.standard_normal((CLIPS, T, HH * WW, GROUPS, C // GROUPS)) * 2 + 1)

    def norm_full(z):
        var, mean = torch.var_mean(z, dim=(1, 4), keepdim=True, correction=0)
        return (z - mean) * torch.rsqrt(var + EPS)

    def norm_shard(z):
        mean, inv = shardctx.group_stats(z, (1, 4), "t", EPS)
        return (z - mean) * inv

    cases["group_stats"] = (x, norm_full, norm_shard, frames, frames)
    # temporal_in, a map that mixes the frames of each pixel, temporal_out
    x = torch.from_numpy(rng.standard_normal((CLIPS * T, HH, WW, C)))
    mix = torch.from_numpy(rng.standard_normal((T, T)) / T ** 0.5)

    def mixed(z):                # (b P', T, C): every frame of a pixel
        return torch.tanh(torch.einsum("ntc,ts->nsc", z, mix))

    def a2a_full(z):
        y = z.reshape(CLIPS, T, HH * WW, C).permute(0, 2, 1, 3).reshape(-1, T, C)
        y = mixed(y).reshape(CLIPS, HH * WW, T, C).permute(0, 2, 1, 3)
        return y.reshape(CLIPS * T, HH, WW, C)

    def a2a_shard(z):
        return shardctx.temporal_out(mixed(shardctx.temporal_in(z, CLIPS, tl)), CLIPS, HH, WW)

    def rows(z, r):              # (CLIPS * T, ...) -> rank r's frames
        return frames(z.reshape((CLIPS, T) + tuple(z.shape[1:])), r).reshape(
            (CLIPS * tl,) + tuple(z.shape[1:]))

    cases["temporal_all_to_all"] = (x, a2a_full, a2a_shard, rows, rows)
    faults = {"halo_t": "halo_dropped", "group_stats": "stats_local",
              "temporal_all_to_all": "all_to_all_not_inverted"}
    for name, (x, full_fn, shard_fn, slab, out_slab) in cases.items():
        comm_report.reset()
        err, fwd = _grad_err(g, x, full_fn, shard_fn, slab, out_slab)
        ex = comm_report.summary()
        kinds = sorted(set(ex["once"]) | set(ex["backward"]))
        fault_err, _ = _grad_err(g, x, full_fn, shard_fn, slab, out_slab, faults[name])
        out[name] = {"grad": err, "forward": fwd, "fault": faults[name],
                     "fault_grad": fault_err, "kinds": kinds}
    return out


# ------------------------------------------------------------- a training step


def engine_config() -> dict:
    """TINY_CPU at 4 frames."""
    cfg = json.loads(json.dumps(TINY_CPU["model"]))
    net = cfg["params"]["network_config"]["params"]
    net["num_frames"] = net["controlnet_config"]["params"]["num_frames"] = STEP_T
    assert net.get("use_checkpoint", True)
    return cfg


def tiny_engine(freeze: str):
    eng = instantiate_from_config(engine_config(), device="cpu")
    eng.freeze_type = freeze
    eng.loss_fn = instantiate_from_config(train.default_loss_config(eng))
    eng.init_weights(torch.Generator().manual_seed(0), zero_init_std=ZERO_INIT_STD)
    return eng


def global_batch():
    ds = NuScenesVideoDataset(infos=make_synthetic_infos(num_frames=4 * STEP_T, seed=0),
                              queue_length=STEP_T, final_dim=FINAL_DIM,
                              image_loader=synthetic_image_loader, seed=0)
    return collate([ds[STEP_T - 1], ds[2 * STEP_T - 1]][:STEP_CLIPS])


def one_step(eng, batch, grid, rows, frames, fault=None):
    """One step over ``grid`` (None: one process) on the rank's ``rows``
    and ``frames``: (loss, gradients the optimizer saw, update, the state)."""
    eng.set_grid(grid)
    state = init_train_state(eng, lr=LR, grad_clip=1.0)
    seen = {}
    step = state.optimizer.step

    def recorded(params, grads):
        seen.update({k: v.detach().clone() for k, v in grads.items()})
        return step(params, grads)

    state.optimizer.step = recorded
    before = {k: v.detach().clone() for k, v in state.params.items()}
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        cond = eng.conditioner(batch, eng.device, generator=gen, apply_ucg=True)
        jpg, cond, draws = train.rank_rows(eng, batch, cond, gen, rows, frames)
    with planted(fault):
        loss = float(train_step(eng, state, jpg, cond, **draws))
    update = {k: state.params[k].detach() - before[k] for k in before}
    return loss, seen, update, state


def update_rel(got: dict, want: dict, grads: dict) -> dict:
    """The AdamW updates' distance over the update's norm: over every
    element (``all``), and over the elements whose one-process gradient
    exceeds GRAD_TOL of the largest (``determined``), with the share of the
    others (``left_out``) and of those whose one-process gradient is
    exactly 0 (``zero_grad``, moved by the weight decay alone). The first
    step moves each element by about lr * sign(gradient); where the
    gradient is within rounding of 0, its sign, and so the update, is a
    coin toss."""
    g = torch.cat([grads[k].reshape(-1) for k in want])
    a = torch.cat([got[k].reshape(-1) for k in want])
    b = torch.cat([want[k].reshape(-1) for k in want])
    keep = g.abs() > GRAD_TOL * g.abs().max()
    return {"all": float((a - b).norm() / b.norm()),
            "determined": float((a - b)[keep].norm() / b[keep].norm()),
            "left_out": float((~keep).sum()) / g.numel(),
            "zero_grad": float((g == 0).sum()) / g.numel()}


def step_cases(grid) -> dict:
    tl = STEP_T // grid.t
    local = STEP_CLIPS // grid.dp
    rows = slice(grid.dp_index * local, (grid.dp_index + 1) * local)
    frames = slice(grid.t_index * tl, (grid.t_index + 1) * tl)
    batch = global_batch()
    out = {"grid": {"dp": grid.dp, "t": grid.t, "dp_index": grid.dp_index,
                    "t_index": grid.t_index}}
    for freeze in ("none", "spatial"):
        loss1, grads1, update1, _ = one_step(tiny_engine(freeze), batch, None, slice(None),
                                             slice(None))
        comm_report.reset()
        eng = tiny_engine(freeze)
        loss, grads, update, state = one_step(eng, batch, grid, rows, frames)
        ex = comm_report.summary()
        try:
            assert_same(list(state.params.values()))
            same = True
        except RuntimeError:
            same = False
        rec = {"loss": loss, "loss_one_process": loss1,
               "loss_rel": abs(loss - loss1) / abs(loss1), "grad": grad_distance(grads, grads1),
               "update": update_rel(update, update1, grads1), "ranks_same": same,
               "trained": len(grads1),
               "exchanges": {p: sorted(ex[p]) for p in comm_report.STEP_PHASES},
               "steps": ex["steps"]}
        if freeze == "spatial":
            _, faulty, _, _ = one_step(tiny_engine(freeze), batch, grid, rows, frames,
                                       fault="halo_dropped")
            rec["fault_halo_dropped_grad"] = grad_distance(faulty, grads1)
        if grid.world == STEP_CLIPS:
            # the rounding floor of any split of the batch: plain data
            # parallelism, one clip a rank with all its frames, no exchange
            _, plain, plain_update, _ = one_step(tiny_engine(freeze), batch, None,
                                                 slice(grid.rank, grid.rank + 1), slice(None))
            rec["plain_dp"] = {"grad": grad_distance(plain, grads1),
                               "update": update_rel(plain_update, update1, grads1)}
        out[freeze] = rec
    return out


def run(dump_dir: str) -> None:
    """Both sets of cases on this rank of the default process group."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    frame_grid = mesh.make_grid(world, 1, "cpu")                  # dp 1, t = world
    train_grid = mesh.make_grid(world, 1, "cpu", dp=world // 2)   # t 2
    out = {"exchanges": exchange_cases(frame_grid), "steps": step_cases(train_grid)}
    os.makedirs(dump_dir, exist_ok=True)
    with open(os.path.join(dump_dir, f"grid_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def resume(dump_dir: str, argv) -> None:
    """The training CLI on ``argv`` in this rank's group; its losses and
    trained parameters to ``dump_dir``."""
    import torch.distributed as dist

    got = train.main(list(argv), save_final=False)
    torch.save({"losses": got["losses"],
                "params": {k: v.detach().clone() for k, v in got["state"].params.items()}},
               os.path.join(dump_dir, f"resumed_rank{dist.get_rank()}.pt"))
