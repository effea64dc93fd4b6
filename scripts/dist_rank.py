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

``cli`` is one of ``inference``, ``train``, ``perception_eval``,
``perception_train``; the arguments after ``--`` go to it. The last line
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
CLIS = {"inference": "panacea_tpu_torch.inference",
        "train": "panacea_tpu_torch.train",
        "perception_eval": "panacea_tpu_torch.perception.eval",
        "perception_train": "panacea_tpu_torch.perception.train_cli"}


def launches(fa, gg) -> dict:
    return {"flash_attention": fa.flash_attention.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "geglu": gg.geglu.launches, "geglu_bwd": gg.geglu_bwd.launches,
            "flash_fp32_kernels": dict(fa.flash_attention.fp32_kernel_launches),
            "flash_bwd_fp32_kernels": dict(fa.flash_attention_bwd.fp32_kernel_launches)}


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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cli", choices=sorted(CLIS))
    p.add_argument("--dump", default=None, help="directory of rank{R}.pt")
    p.add_argument("--no_final", action="store_true")
    argv = sys.argv[1:]
    split = argv.index("--") if "--" in argv else len(argv)
    args = p.parse_args(argv[:split])
    cli_argv = argv[split + 1:]

    import importlib

    import torch

    from panacea_tpu_torch.models.engine import DiffusionEngine3D
    from panacea_tpu_torch.ops import flash_attention as fa
    from panacea_tpu_torch.ops import geglu as gg
    from panacea_tpu_torch.parallel import mesh
    from panacea_tpu_torch.perception.train import DetectorTrainer

    # what the CLI's process group context yields, and a record of the
    # latents it samples, of its training steps and of what it scores
    seen, latents, steps, first = [], [], [], {}
    group_of = mesh.process_group

    @contextlib.contextmanager
    def recorded_group(device=None):
        with group_of(device) as group:
            seen.append(group)
            yield group

    mesh.process_group = recorded_group
    sample = DiffusionEngine3D.sample

    def recorded_sample(self, *a, **kw):
        out = sample(self, *a, **kw)
        latents.append(out.detach().float().cpu())
        return out

    DiffusionEngine3D.sample = recorded_sample
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
    t0 = time.perf_counter()
    if args.cli == "train":
        out = cli.main(cli_argv, save_final=not args.no_final)
    else:
        out = cli.main(cli_argv)
    seconds = time.perf_counter() - t0
    group = seen[-1]
    report = {"cli": args.cli, "rank": group.rank, "world": group.world,
              "backend": group.backend, "device": str(group.device),
              "launches": launches(fa, gg), "seconds": seconds,
              # the port runs without JAX: none of it, nor the JAX package, is loaded
              "jax_modules": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "flax", "optax", "panacea_tpu"))}
    if group.device.type == "cuda":
        report["card"] = torch.cuda.get_device_name(group.device)
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated(group.device) / 1e9
    timer = out.get("timer") if isinstance(out, dict) else None
    if timer is not None:
        report["phase_s"] = {k: timer.mean(k) for k in timer.totals}
        report["phase_last_s"] = dict(timer.last)
        report["phase_counts"] = dict(timer.counts)
    dump = {}
    if args.cli == "inference":
        report["clips"] = out["done"]
        dump["latents"] = latents
    elif args.cli == "train":
        state, engine = out["state"], out["engine"]
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
