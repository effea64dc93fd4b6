#!/usr/bin/env python3
"""Run one of the port's CLIs in this process and report what the rank did.

Under ``torchrun`` each worker runs this script, so each rank prints its own
report; without it, the CLI runs as one process. The CLI sets up its
process group itself (``panacea_tpu_torch/parallel/mesh.py``).

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        scripts/dist_rank.py inference --dump out/ranks -- \\
        --synthetic --tiny --device cpu --num_batches 2 --outdir out/gen
    python scripts/dist_rank.py train --dump out/one -- --tiny --synthetic --bs 2 --steps 2 \\
        --device cpu

``cli`` is one of ``inference``, ``inference_view_shard``, ``train``,
``perception_eval``, ``perception_train``; the arguments after ``--`` go to
it. ``inference_view_shard`` is the inference CLI sampling each clip over
the ranks (its arguments must hold ``--view_shard V``); its report adds the
grid, the exchanges by kind with their bytes and host milliseconds
(``parallel/comm_report.py``), the clip's split and the flash launches by
shape, and its dump holds the whole clip's latents on every rank. With
``--replay DTYPE ...`` the ranks then repeat the CLI's last sample call for
one step (its conditioning and generator state) with the network in each
type: over the grid, and with a planted fault (each rank's own boundary
views in place of its neighbours' in the cross-view ring, set here and by
no switch of the package); rank 0 then repeats it alone while the others
wait. The report's ``against_one_process`` holds, by type, the largest
difference over the largest latent and the relative RMS of the grid's and
the fault's latents from rank 0's alone; the counts, the exchanges and the
clip's split above are the CLI's, taken before the replays.
For ``train`` the report adds the grid (``dp``, ``t`` and this rank's
indices; None for plain data parallelism), the rank's slab (its clips
and frames of the global batch) and the exchanges of its steps by kind
and direction (``forward``, ``recompute``, ``backward``), and ``--replay
DTYPE ...`` repeats the last step's forward and backward with the network
in each type on the first clip of each clip group (the step's batch,
conditioning and generator state): over the grid, with a planted fault
(each rank keeps its own frames' gradient and sends its halo's back to no
one, set here and by no switch of the package), then on rank 0 alone with
those clips whole while the others wait; ``against_one_process`` holds,
by type, the distances of the grid's and the fault's trained gradients
(the ranks' mean) from rank 0's alone, jointly over the norm of rank 0's
and the largest parameter's over its own norm (``grad_distance``).
``--zero_init_std S`` draws the weights the model zero-initialises with
std ``S`` (``DiffusionEngine3D.init_weights``), so that every branch
computes on random weights. The last line
this script prints is ``{"rank_report": {...}}``: the rank, world size,
backend and device the CLI took, the launches of the port's kernels (and
for the trainers a step's), the seconds of the run, the CLI's phase times,
peak device memory, and what the CLI returned that a caller compares
(losses, metrics); the phase times are the mean over the run and the
last step's or clip's. ``--dump DIR`` writes ``DIR/rank{R}.pt`` beside it:
inference, the sampled latents of each clip (from ``DiffusionEngine3D.sample``);
train, the losses and, for every trained parameter, its values after the
run and at the random init (the seed's weights drawn again) at up to
``SAMPLES`` positions drawn from the parameter's name; perception_train,
the trained parameters at those positions before the first step and after
the last; perception_eval, on rank 0 the merged predictions that were
scored. ``--no_final`` gives
the generator's trainer ``save_final=False`` (its final saves are 27 GB at
full width).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SAMPLES = 4096
# a parameter whose gradient norm is at most this share of the whole is at
# rounding level (``grad_distance``)
ROUNDING = 1e-6
CLIS = {"inference": "panacea_tpu_torch.inference",
        "inference_view_shard": "panacea_tpu_torch.inference",
        "train": "panacea_tpu_torch.train",
        "perception_eval": "panacea_tpu_torch.perception.eval",
        "perception_train": "panacea_tpu_torch.perception.train_cli"}


def launches(fa, gg) -> dict:
    """The launch counters, as ``chip_smoke.py``'s ``read_counts``."""
    return {"flash_attention": fa.flash_attention.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "geglu": gg.geglu.launches, "geglu_bwd": gg.geglu_bwd.launches,
            "flash_routes": dict(fa.flash_attention.route_launches),
            "flash_fp32_kernels": dict(fa.flash_attention.fp32_kernel_launches),
            "flash_bwd_routes": dict(fa.flash_attention_bwd.route_launches),
            "flash_bwd_fp32_kernels": dict(fa.flash_attention_bwd.fp32_kernel_launches),
            "geglu_routes": dict(gg.geglu.route_launches)}


def sampled(torch, tensors: dict) -> dict:
    """Each tensor's values at up to SAMPLES positions drawn from its name
    (all of them where it has fewer), as fp32 on the CPU."""
    out = {}
    for name, t in tensors.items():
        flat = t.detach().reshape(-1)
        if flat.numel() > SAMPLES:
            g = torch.Generator().manual_seed(zlib.crc32(name.encode()))
            idx = torch.randint(0, flat.numel(), (SAMPLES,), generator=g)
            flat = flat[idx.to(flat.device)]
        out[name] = flat.float().cpu().clone()
    return out


def distance(got, want) -> dict:
    """The largest difference over the largest value, and the relative RMS."""
    d = got.double() - want.double()
    return {"max_rel": float(d.abs().max() / want.double().abs().max()),
            "rms_rel": float(d.norm() / want.double().norm())}


def replay_against_one_process(torch, sample, call: dict, rank: int, dtypes) -> dict:
    """The CLI's last sample call again, one step, with the network in each
    of ``dtypes`` (``sample``, the unrecorded ``DiffusionEngine3D.sample``):
    over the grid, with the ring fault, and on rank 0 alone
    (the grid unset) while the others wait. On rank 0, by type, the
    distances of the grid's and the fault's latents from its own alone and
    the seconds of each; on the other ranks, the seconds."""
    from panacea_tpu_torch.parallel import shardctx
    from panacea_tpu_torch.parallel.train import barrier

    eng, types = call["engine"], {"fp32": torch.float32, "bf16": torch.bfloat16}
    grid, clip_dtype = eng.grid, eng.dtype

    def run(dtype):
        eng.model.to(dtype)
        eng.dtype = dtype
        gen = call["kw"].get("generator")
        if gen is not None:
            gen.set_state(call["state"])
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        t0 = time.perf_counter()
        out = sample(eng, *call["a"], **dict(call["kw"], num_steps=1)).float().cpu()
        return out, time.perf_counter() - t0

    def faulty(dtype):
        exchange = shardctx.ring_exchange
        shardctx.ring_exchange = lambda to_right, to_left: (to_right, to_left)
        try:
            return run(dtype)
        finally:
            shardctx.ring_exchange = exchange

    out = {}
    for name in dtypes:   # each type's three runs on the same weights
        (got, grid_s), (fault, fault_s) = run(types[name]), faulty(types[name])
        out[name] = {"grid_s": grid_s, "fault_s": fault_s}
        if rank == 0:
            eng.set_grid(None)
            alone, out[name]["alone_s"] = run(types[name])
            eng.set_grid(grid)
            out[name].update(grid=distance(got, alone), fault=distance(fault, alone),
                             latent_abs_max=float(alone.abs().max()))
        barrier()
    eng.model.to(clip_dtype)
    eng.dtype = clip_dtype
    return out


def grad_distance(got: dict, want: dict) -> dict:
    """Two gradients' distance: jointly over the norm of ``want``, and each
    parameter's over its own norm in ``want`` (the largest, ``max_param``),
    leaving out the parameters whose gradient in ``want`` is at rounding
    level (its norm at most ``ROUNDING`` of the whole: a bias before a
    GroupNorm of one channel a group, whose exact gradient is 0). Those are
    named (``rounding``) and held over the whole norm (``rounding_max``)."""
    norm = sum(float(w.double().norm()) ** 2 for w in want.values()) ** 0.5
    diff = {k: float((got[k].double() - w.double()).norm()) for k, w in want.items()}
    small = sorted(k for k, w in want.items() if float(w.double().norm()) <= ROUNDING * norm)
    own = {k: diff[k] / float(w.double().norm()) for k, w in want.items() if k not in small}
    return {"joint": sum(v * v for v in diff.values()) ** 0.5 / norm,
            "max_param": max(own.values()), "worst": max(own, key=own.get),
            "rounding": small, "rounding_max": max((diff[k] / norm for k in small), default=0.0)}


@contextlib.contextmanager
def no_reduce_beside(shards, kept: dict):
    """The planted fault of the sharded step, computed beside the sound one
    in the same backward: what each rank would hold had it kept its own
    gradient slice and skipped the reduce-scatter (its slice of its own
    gradient, divided by the world size as the reduce's mean is), into
    ``kept`` by name. Set here, by no switch of the package."""
    sound = shards.scatter_grads

    def scatter(leaves, grads):
        for leaf, g in zip(leaves, grads):
            if g is not None:
                kept[leaf.name] = shards.local(leaf.name, g.float()) / shards.world
        return sound(leaves, grads)

    shards.scatter_grads = scatter
    try:
        yield
    finally:
        del shards.scatter_grads


def update_distance(got: dict, want: dict) -> float:
    """Two AdamW updates' distance over the norm of ``want``."""
    num = sum(float((got[k].double() - w.double()).norm()) ** 2 for k, w in want.items())
    return (num / sum(float(w.double().norm()) ** 2 for w in want.values())) ** 0.5


def dropped_halo_grad(ctx, gy):
    """The planted fault: a frame halo's gradient stays with the rank that
    received the frames, and its own frames get theirs alone."""
    return gy.narrow(1, ctx.pad, gy.shape[1] - 2 * ctx.pad), None, None


def replay_train_against_one_process(torch, rank_rows, call: dict, rank: int, dtypes,
                                     lr: float, grad_clip: float) -> dict:
    """The CLI's last step again, forward and backward, with the network in
    each of ``dtypes``, on the first clip of each clip group: over the grid,
    with the halo fault, and on rank 0 alone with those clips whole (the
    grid unset) while the others wait. ``rank_rows`` is the trainer's own.
    On rank 0, by type, the gradients' distances from its own alone and
    the seconds of each; on the other ranks, the seconds. Under a sharded
    state (``--fsdp``) the grid's gradients are the reduce-scattered ones,
    gathered whole for rank 0; rank 0 alone runs on the gathered network
    (``Shards.unsharded``), as does the halo fault, which is the grid's;
    and the sharded gradient and rank 0's also take one AdamW step
    (``lr``, ``grad_clip``; fresh moments, on copies of the masters), the
    sharded one over the ranks' slices with the norm over the ranks, so
    that ``update`` and ``fault_no_reduce`` (each rank keeping its own
    gradient slice, unreduced: computed beside the grid's backward,
    ``no_reduce_beside``) hold the sharded step's update against rank 0's
    alone."""
    from panacea_tpu_torch.parallel import shardctx
    from panacea_tpu_torch.parallel.train import allreduce_mean, barrier
    from panacea_tpu_torch.train_step import local_grads
    from panacea_tpu_torch.utils.optim import AdamW

    eng, types = call["engine"], {"fp32": torch.float32, "bf16": torch.bfloat16}
    grid, step_dtype, shards = eng.grid, eng.dtype, eng.shards
    dp, d, t, i = (1, 0, 1, 0) if grid is None else (grid.dp, grid.dp_index, grid.t,
                                                     grid.t_index)
    tl = eng.num_frames // t
    mine, every = (slice(d, d + 1), slice(i * tl, (i + 1) * tl)), (slice(0, dp), slice(None))

    def step_update(net, grads):
        """One AdamW step on copies of the masters: the update, whole on rank 0."""
        masters = {k: p.detach().float().clone() for k, p in net.items()}
        before = {k: v.clone() for k, v in masters.items()}
        AdamW(masters, lr=lr, grad_clip=grad_clip, shards=eng.shards).step(masters, grads)
        update = {k: masters[k] - before[k] for k in masters}
        del masters, before
        if eng.shards is not None:
            update = eng.shards.full(update)
        return ({k: u.float().cpu() for k, u in update.items()}
                if rank == 0 and update is not None else None)

    def run(dtype, rows, frames, reduce, tee=False, update=False):
        eng.model.to(dtype)
        eng.dtype = dtype
        net = eng.set_trainable()
        gen = call["generator"]
        gen.set_state(call["state"])
        with torch.no_grad():
            jpg, cond, draws = rank_rows(eng, call["batch"], call["cond"], gen, rows, frames)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        t0 = time.perf_counter()
        kept = {}
        with (no_reduce_beside(eng.shards, kept) if tee else contextlib.nullcontext()):
            local_grads(eng, net, jpg, cond, **draws)
        if eng.shards is not None:
            grads = eng.shards.grads_of(net)
        elif reduce:
            grads = dict(zip(net, allreduce_mean([p.grad for p in net.values()])))
        else:
            grads = {k: p.grad for k, p in net.items()}
        updates = []
        if update:                 # the step's AdamW update (and the fault's)
            updates.append(step_update(net, grads))
            if tee:
                updates.append(step_update(net, dict(grads, **kept)))
        del kept
        if eng.shards is not None:
            grads = eng.shards.full(grads)
        out = ({k: g.detach().float().cpu() for k, g in grads.items()} if rank == 0
               else None)
        del grads
        for p in net.values():
            p.grad = None
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
            seconds = time.perf_counter() - t0
            torch.cuda.empty_cache()   # room for rank 0 alone beside the others
        else:
            seconds = time.perf_counter() - t0
        return out, updates, seconds

    def faulty(dtype):
        sound = shardctx._HaloT.backward
        shardctx._HaloT.backward = staticmethod(dropped_halo_grad)
        try:
            return run(dtype, *mine, True)
        finally:
            shardctx._HaloT.backward = sound

    out = {}
    sharded = shards is not None
    for name in dtypes:
        got, upd, grid_s = run(types[name], *mine, True, tee=sharded, update=sharded)
        # the halo fault and rank 0 alone on the network gathered whole: the
        # fault is the grid's (the check without --fsdp), not the sharded state's. The
        # network goes back to its own type first, so that the gather moves
        # half the bytes of fp32 (each pass casts it as the grid's did)
        eng.model.to(step_dtype)
        with (contextlib.nullcontext() if shards is None else shards.unsharded()):
            fault, _, fault_s = faulty(types[name])
            out[name] = {"grid_s": grid_s, "fault_s": fault_s}
            if rank == 0:
                eng.set_grid(None)
                alone, upd_alone, out[name]["alone_s"] = run(types[name], *every, False,
                                                             update=sharded)
                eng.set_grid(grid)
                out[name].update(grid=grad_distance(got, alone),
                                 fault=grad_distance(fault, alone), clips=dp,
                                 frames=eng.num_frames)
                if shards is not None:
                    out[name].update(update=update_distance(upd[0], upd_alone[0]),
                                     fault_no_reduce=update_distance(upd[1], upd_alone[0]))
            barrier()
    eng.model.to(step_dtype)
    eng.dtype = step_dtype
    eng.set_trainable()
    return out


def fsdp_report(shards, state, engine) -> dict:
    """The sharded layout and this rank's training state: measured on its
    tensors and counted from the layout."""
    from panacea_tpu_torch.parallel.fsdp import measured_bytes

    net_size = next(engine.model.parameters()).element_size()
    return {"leaves_split": len(shards.leaves), "leaves": len(shards.dims),
            "params_split": sum(shards.numel[k] for k in shards.leaves),
            "params": sum(shards.numel.values()), "min_size": shards.min_size,
            "units": len(shards.units), "state_bytes": measured_bytes(state, engine),
            "counted_bytes": shards.counted_bytes(list(state.params), net_size,
                                                  state.ema is not None)}


def none_ema_step(torch, rank_rows, call: dict, states: list, group) -> dict:
    """One bf16 step of the CLI's engine with every network parameter
    trained (``freeze_type none``) and the EMA on, on the first clip of the
    CLI's last batch and this rank's frames of it, after the CLI's own train
    state is emptied: the rank's state measured and counted from the layout
    (``fsdp_report``), its device memory after the step and its peak, the
    step's seconds and split, and its exchanges by kind and direction."""
    from panacea_tpu_torch.parallel import comm_report
    from panacea_tpu_torch.parallel.train import barrier
    from panacea_tpu_torch.train import GRAD_CLIP
    from panacea_tpu_torch.train_step import init_train_state, train_step
    from panacea_tpu_torch.utils.profiling import Timer

    eng = call["engine"]
    for st in states:                       # the CLI's state, no longer read
        st.params.clear()
        st.optimizer.mu.clear()
        st.optimizer.nu.clear()
        if st.ema is not None:
            st.ema.shadows.clear()
    states.clear()
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(eng.device)
    eng.freeze_type = "none"
    state = init_train_state(eng, lr=2e-5, grad_clip=GRAD_CLIP, use_ema=True)
    grid = eng.grid
    t, i = (1, 0) if grid is None else (grid.t, grid.t_index)
    tl = eng.num_frames // t
    gen = call["generator"]
    gen.set_state(call["state"])
    with torch.no_grad():
        jpg, cond, draws = rank_rows(eng, call["batch"], call["cond"], gen, slice(0, 1),
                                     slice(i * tl, (i + 1) * tl))
    comm_report.reset()
    timer = Timer(eng.device)
    barrier()
    t0 = time.perf_counter()
    loss = float(train_step(eng, state, jpg, cond, timer=timer, **draws))
    seconds = time.perf_counter() - t0
    out = {"loss": loss, "s_per_step": seconds, "split_s": dict(timer.last),
           "exchanges": comm_report.summary(),
           "trained_params": sum(p.numel() for p in state.params.values())}
    if eng.shards is not None:
        out.update(fsdp_report(eng.shards, state, eng))
    if cuda:
        out["allocated_gb"] = torch.cuda.memory_allocated(eng.device) / 1e9
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(eng.device) / 1e9
    state.params.clear()
    state.optimizer.mu.clear()
    state.optimizer.nu.clear()
    state.ema.shadows.clear()
    barrier()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cli", choices=sorted(CLIS))
    p.add_argument("--dump", default=None, help="directory of rank{R}.pt")
    p.add_argument("--no_final", action="store_true")
    p.add_argument("--replay", nargs="+", choices=("fp32", "bf16"), default=(),
                   help="inference_view_shard and train: the replays against rank 0 "
                        "alone, by network type")
    p.add_argument("--zero_init_std", type=float, default=None)
    p.add_argument("--none_ema_step", action="store_true",
                   help="train: after the CLI and the replays, one more step on the CLI's "
                        "engine with every network parameter trained and the EMA on, on "
                        "the first clip of the last batch")
    argv = sys.argv[1:]
    split = argv.index("--") if "--" in argv else len(argv)
    args = p.parse_args(argv[:split])
    cli_argv = argv[split + 1:]
    if args.cli == "inference_view_shard" and "--view_shard" not in cli_argv:
        p.error("inference_view_shard needs --view_shard V among the CLI's arguments")
    if args.replay and args.cli not in ("inference_view_shard", "train"):
        p.error("--replay is for inference_view_shard and train")
    if args.none_ema_step and args.cli != "train":
        p.error("--none_ema_step is for train")

    import importlib

    import torch

    from panacea_tpu_torch import train_step
    from panacea_tpu_torch.models.engine import DiffusionEngine3D
    from panacea_tpu_torch.ops import flash_attention as fa
    from panacea_tpu_torch.ops import geglu as gg
    from panacea_tpu_torch.parallel import comm_report, mesh
    from panacea_tpu_torch.perception.train import DetectorTrainer

    # what the CLI's process group context yields, and a record of the
    # latents it samples (and of its last sample call), of its training
    # steps and of what it scores
    seen, latents, steps, first, calls, cli_end = [], [], [], {}, [], {}
    group_of = mesh.process_group

    @contextlib.contextmanager
    def recorded_group(device=None):
        with group_of(device) as group:
            seen.append(group)
            yield group
            # the CLI's run has ended; its group is still up for the replays
            cli_end.update(t=time.perf_counter(), counts=launches(fa, gg),
                           exchanges=comm_report.summary(),
                           shapes=dict(fa.flash_attention.shape_launches))
            if group.device.type == "cuda":
                cli_end["peak_mem_gb"] = torch.cuda.max_memory_allocated(group.device) / 1e9
            if args.cli == "train":
                state = states[-1]
                cli_end["trained"] = {k: p.numel() for k, p in state.params.items()}
                cli_end["fsdp"] = (None if state.shards is None else
                                   fsdp_report(state.shards, state, state_engine[-1]))
            if args.cli == "train" and args.dump:
                # the dump's trained parameters and shadows, whole (gathered
                # where the state is sharded), before anything else runs
                def whole(tensors):
                    if state.shards is None:
                        return tensors
                    return state.shards.full(tensors, everywhere=True)

                cli_end["dump"] = {"final": sampled(torch, whole(state.params)), "ema": None}
                if state.ema is not None:
                    cli_end["dump"]["ema"] = sampled(torch, whole(state.ema.shadows))
            cli_end["hook_s"] = {"dump": time.perf_counter() - cli_end["t"]}
            if args.replay and args.cli == "train":
                cli_parsed = cli.get_parser().parse_known_args(cli_argv)[0]
                cli_end["against_one_process"] = replay_train_against_one_process(
                    torch, rank_rows, calls[-1], group.rank, args.replay, cli_parsed.lr,
                    cli.GRAD_CLIP)
            elif args.replay and calls:
                cli_end["against_one_process"] = replay_against_one_process(
                    torch, sample, calls[-1], group.rank, args.replay)
            cli_end["hook_s"]["replay"] = time.perf_counter() - cli_end["t"]
            if args.none_ema_step:
                cli_end["none_ema_step"] = none_ema_step(torch, rank_rows, calls[-1], states,
                                                         group)
            cli_end["hook_s"]["none_ema_step"] = time.perf_counter() - cli_end["t"]

    mesh.process_group = recorded_group
    sample = DiffusionEngine3D.sample

    def recorded_sample(self, *a, **kw):
        gen = kw.get("generator")
        state = None if gen is None else gen.get_state()
        out = sample(self, *a, **kw)
        latents.append(out.detach().float().cpu())
        if args.replay:
            calls[:] = [{"engine": self, "a": a, "kw": kw, "state": state}]
        return out

    DiffusionEngine3D.sample = recorded_sample
    # the trainer's weights as drawn (before any step or split) and its train
    # states, for the dump and the extra step
    init, states, state_engine = {}, [], []
    init_weights = DiffusionEngine3D.init_weights

    def recorded_init(self, generator, zero_init_std=0.0):
        if args.zero_init_std is not None:
            zero_init_std = args.zero_init_std
        out = init_weights(self, generator, zero_init_std=zero_init_std)
        if args.cli == "train" and args.dump:
            init.update(sampled(torch, {f"model.{n}": p for n, p in
                                        self.model.named_parameters()}))
        return out

    DiffusionEngine3D.init_weights = recorded_init
    init_train_state = train_step.init_train_state

    def recorded_state(engine, *a, **kw):
        states.append(init_train_state(engine, *a, **kw))
        state_engine.append(engine)
        return states[-1]

    train_step.init_train_state = recorded_state
    det_step = DetectorTrainer.step

    def timed_step(self, state, *a, **kw):
        dev = next(state.model.parameters()).device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if not first:
            first.update(sampled(torch, state.params))
        before, t0 = launches(fa, gg), time.perf_counter()
        out = det_step(self, state, *a, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        after = launches(fa, gg)
        steps.append({"s": time.perf_counter() - t0,
                      "flash_attention": after["flash_attention"] - before["flash_attention"],
                      "flash_attention_bwd": (after["flash_attention_bwd"]
                                              - before["flash_attention_bwd"])})
        return out

    DetectorTrainer.step = timed_step
    from panacea_tpu_torch.perception import metrics as det_metrics

    scored = []
    evaluate = det_metrics.evaluate_detections

    def recorded_evaluate(preds, gts, *a, **kw):
        scored.append([{k: torch.as_tensor(v).cpu() for k, v in p.items()} for p in preds])
        return evaluate(preds, gts, *a, **kw)

    det_metrics.evaluate_detections = recorded_evaluate

    cli = importlib.import_module(CLIS[args.cli])
    rank_rows = getattr(cli, "rank_rows", None)
    if args.cli == "train":
        def recorded_rows(engine, batch, cond, generator, *a):
            # the last step's inputs, before its draws, for the replays
            calls[:] = [{"engine": engine, "batch": batch, "cond": cond,
                         "generator": generator, "state": generator.get_state()}]
            return rank_rows(engine, batch, cond, generator, *a)

        cli.rank_rows = recorded_rows
    comm_report.reset()
    fa.flash_attention.shape_launches.clear()
    t0 = time.perf_counter()
    if args.cli == "train":
        out = cli.main(cli_argv, save_final=not args.no_final)
    else:
        out = cli.main(cli_argv)
    seconds = cli_end.get("t", time.perf_counter()) - t0
    group = seen[-1]
    report = {"cli": args.cli, "rank": group.rank, "world": group.world,
              "after_cli_s": cli_end.get("hook_s"),
              "backend": group.backend, "device": str(group.device),
              "launches": cli_end.get("counts", launches(fa, gg)), "seconds": seconds,
              # the port runs without JAX: none of it, nor the JAX package, is loaded
              "jax_modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "flax", "optax", "panacea_tpu"))}
    if group.device.type == "cuda":
        report["card"] = torch.cuda.get_device_name(group.device)
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated(group.device) / 1e9
        report["cli_peak_mem_gb"] = cli_end.get("peak_mem_gb")
    timer = out.get("timer") if isinstance(out, dict) else None
    if timer is not None:
        report["phase_s"] = {k: timer.mean(k) for k in timer.totals}
        report["phase_last_s"] = dict(timer.last)
        report["phase_counts"] = dict(timer.counts)
    dump = {}
    if args.cli == "inference_view_shard":
        g = out["grid"]
        report["grid"] = (None if g is None else
                          {k: getattr(g, k) for k in ("t", "view", "t_index", "view_index",
                                                      "host_staged")})
        report["exchanges"] = cli_end["exchanges"]
        report["clip_split_s"] = out["clip_split"]
        report["flash_launches_by_shape"] = cli_end["shapes"]
        if args.replay:
            report["against_one_process"] = cli_end.get("against_one_process")
    if args.cli.startswith("inference"):
        report["clips"] = out["done"]
        dump["latents"] = latents
    elif args.cli == "train":
        state, g = out["state"], out["grid"]
        rows, frames = out["slab"]
        report["grid"] = (None if g is None else
                          {k: getattr(g, k) for k in ("dp", "t", "dp_index", "t_index",
                                                      "host_staged")})
        report["slab"] = {"clips": [rows.start, rows.stop], "frames": [frames.start, frames.stop]}
        report["exchanges"] = cli_end["exchanges"]
        report["flash_launches_by_shape"] = cli_end["shapes"]
        if args.replay:
            report["against_one_process"] = cli_end.get("against_one_process")
        report["losses"] = out["losses"]
        report["steps"] = len(out["losses"])
        shards, trained = state.shards, cli_end["trained"]
        report["trained_params"] = sum(trained.values())
        if shards is None:
            # allreduce_mean sends every trained gradient once, in fp32
            report["allreduce_bytes_per_step"] = 4 * report["trained_params"]
        else:
            # the replicated trained leaves' gradients (the split ones are
            # reduce-scattered, counted in the exchanges)
            report["allreduce_bytes_per_step"] = 4 * sum(
                n for k, n in trained.items() if k not in shards.leaves)
        if args.none_ema_step:
            report["none_ema_step"] = cli_end["none_ema_step"]
        report["fsdp"] = cli_end["fsdp"]
        if args.dump:
            dump["losses"] = out["losses"]
            dump["final"] = cli_end["dump"]["final"]
            if cli_end["dump"]["ema"] is not None:
                dump["ema"] = cli_end["dump"]["ema"]
            dump["init"] = {k: init[k] for k in trained}
    elif args.cli == "perception_train":
        report["final_metrics"] = out["final_metrics"]
        report["steps"] = steps
        dump.update(init=first, final=sampled(torch, out["state"].params))
    else:
        report["metrics"] = {k: float(v) for k, v in out.items()}
        dump["predictions"] = scored[-1] if scored else None
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
        torch.save(dict(dump, report=report), os.path.join(args.dump, f"rank{group.rank}.pt"))
    # one write of one line: the ranks share the launcher's stdout
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (json.dumps({"rank_report": report}) + "\n").encode())
    return 0


if __name__ == "__main__":
    sys.exit(main())
