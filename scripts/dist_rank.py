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


def dropped_halo_grad(ctx, gy):
    """The planted fault: a frame halo's gradient stays with the rank that
    received the frames, and its own frames get theirs alone."""
    return gy.narrow(1, ctx.pad, gy.shape[1] - 2 * ctx.pad), None, None


def replay_train_against_one_process(torch, rank_rows, call: dict, rank: int, dtypes) -> dict:
    """The CLI's last step again, forward and backward, with the network in
    each of ``dtypes``, on the first clip of each clip group: over the grid,
    with the halo fault, and on rank 0 alone with those clips whole (the
    grid unset) while the others wait. ``rank_rows`` is the trainer's own.
    On rank 0, by type, the gradients' distances from its own alone and
    the seconds of each; on the other ranks, the seconds."""
    from panacea_tpu_torch.parallel import shardctx
    from panacea_tpu_torch.parallel.train import allreduce_mean, barrier
    from panacea_tpu_torch.train_step import local_grads

    eng, types = call["engine"], {"fp32": torch.float32, "bf16": torch.bfloat16}
    grid, step_dtype = eng.grid, eng.dtype
    dp, d, t, i = (1, 0, 1, 0) if grid is None else (grid.dp, grid.dp_index, grid.t,
                                                     grid.t_index)
    tl = eng.num_frames // t
    net = eng.set_trainable()

    def run(dtype, rows, frames, reduce):
        eng.model.to(dtype)
        eng.dtype = dtype
        gen = call["generator"]
        gen.set_state(call["state"])
        with torch.no_grad():
            jpg, cond, draws = rank_rows(eng, call["batch"], call["cond"], gen, rows, frames)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        t0 = time.perf_counter()
        local_grads(eng, net, jpg, cond, **draws)
        grads = [p.grad for p in net.values()]
        if reduce:
            grads = allreduce_mean(grads)
        out = ({k: g.detach().float().cpu() for k, g in zip(net, grads)} if rank == 0
               else None)
        for p in net.values():
            p.grad = None
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
            seconds = time.perf_counter() - t0
            torch.cuda.empty_cache()   # room for rank 0 alone beside the others
            return out, seconds
        return out, time.perf_counter() - t0

    def faulty(dtype):
        sound = shardctx._HaloT.backward
        shardctx._HaloT.backward = staticmethod(dropped_halo_grad)
        try:
            return run(dtype, slice(d, d + 1), slice(i * tl, (i + 1) * tl), True)
        finally:
            shardctx._HaloT.backward = sound

    out = {}
    for name in dtypes:
        got, grid_s = run(types[name], slice(d, d + 1), slice(i * tl, (i + 1) * tl), True)
        fault, fault_s = faulty(types[name])
        out[name] = {"grid_s": grid_s, "fault_s": fault_s}
        if rank == 0:
            eng.set_grid(None)
            alone, out[name]["alone_s"] = run(types[name], slice(0, dp), slice(None), False)
            eng.set_grid(grid)
            out[name].update(grid=grad_distance(got, alone), fault=grad_distance(fault, alone),
                             clips=dp, frames=eng.num_frames)
        barrier()
    eng.model.to(step_dtype)
    eng.dtype = step_dtype
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
    argv = sys.argv[1:]
    split = argv.index("--") if "--" in argv else len(argv)
    args = p.parse_args(argv[:split])
    cli_argv = argv[split + 1:]
    if args.cli == "inference_view_shard" and "--view_shard" not in cli_argv:
        p.error("inference_view_shard needs --view_shard V among the CLI's arguments")
    if args.replay and args.cli not in ("inference_view_shard", "train"):
        p.error("--replay is for inference_view_shard and train")

    import importlib

    import torch

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
            if args.replay and args.cli == "train":
                cli_end["against_one_process"] = replay_train_against_one_process(
                    torch, rank_rows, calls[-1], group.rank, args.replay)
            elif args.replay and calls:
                cli_end["against_one_process"] = replay_against_one_process(
                    torch, sample, calls[-1], group.rank, args.replay)

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
    if args.zero_init_std is not None:
        init_weights = DiffusionEngine3D.init_weights

        def drawn_zero_init(self, generator, zero_init_std=0.0):
            return init_weights(self, generator, zero_init_std=args.zero_init_std)

        DiffusionEngine3D.init_weights = drawn_zero_init
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
        state, engine, g = out["state"], out["engine"], out["grid"]
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
        report["trained_params"] = sum(p.numel() for p in state.params.values())
        # allreduce_mean sends every trained gradient once, in fp32
        report["allreduce_bytes_per_step"] = 4 * report["trained_params"]
        if args.dump:
            dump["losses"] = out["losses"]
            dump["final"] = sampled(torch, state.params)
            if state.ema is not None:
                dump["ema"] = sampled(torch, state.ema.shadows)
            seed = cli.get_parser().parse_known_args(cli_argv)[0].seed
            engine.init_weights(torch.Generator(device=engine.device).manual_seed(seed))
            network = dict(engine.named_parameters())
            dump["init"] = sampled(torch, {k: network[k] for k in state.params})
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
