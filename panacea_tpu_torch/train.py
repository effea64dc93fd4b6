"""Training entry point of the port (counterpart of the JAX package's root
``train.py``): the generator trained with the diffusion loss, on one card
or data-parallel over several.

The JAX CLI's flags and defaults, plus ``--device`` (the card by default;
``--device cpu`` for tests). One step: a batch of clips picked with the JAX
CLI's ``np.random.RandomState(seed).randint(t - 1, len, bs)`` (so both CLIs
read the same clips), the conditioning with ucg dropout, and
``train_step.train_step``. Every ``--ckpt_every`` steps a rotating full-state
checkpoint ``{ckpt_dir}/iter_N`` (``--resume`` continues from it exactly);
at the end ``final.pt`` (the network's parameters, fp32), ``final_ema.pt``
(the EMA shadows, with ``--use_ema``) and ``engine_final.ckpt``, a reference
style checkpoint that ``inference_torch.py --ckpt`` loads (``--prefer_ema``
for the shadows).

Parallelism (the JAX CLI's mesh of ``dp`` clip groups by ``t`` frame ranks,
``train.py:145-147``): under ``torchrun --nproc_per_node N`` each rank holds
the parameters, ``--bs`` is the global batch split evenly over the ``dp``
clip groups, and each clip's frames are split over the ``t = N / dp`` ranks
of its group. ``--dp`` defaults to the JAX CLI's ``max(1, N // T)`` for
clips of T frames, so two to T processes train one clip's frames over all
of them (``--dp N``: plain data parallelism). Rank ``(d * t + i)`` takes
clip group ``d``'s clips and frames ``[i T / t, (i + 1) T / t)`` of each.
A step is the one-process step of the global batch: every rank reads the
whole batch and computes its conditioning with the ucg dropout, as the
JAX CLI's processes do (so the dataset's own random stream stays the same
on every rank), draws the posterior, sigmas and noise at the global
batch's shape from the shared generator, keeps its own clips' slab of
frames (``rank_rows``), VAE-encodes only those frames, runs the network
under the grid (``parallel/shardctx.py``: the frame halos, the temporal
statistics and the all-to-all cross the clip group, forward and
backward), and averages its gradients with the other ranks' before the
optimizer (``parallel/train.py``; ``train_step.py`` says why that mean is
the global batch's gradient). Rank 0 writes the checkpoints. ``t`` must
divide T.

``--fsdp`` shards the training state over all N ranks, as the JAX CLI's
(``train.py:179-188``, ZeRO-3, the layout the reference trained under with
DeepSpeed): the network's parameters, trained and frozen, their fp32
masters, AdamW's moments, the EMA shadows and the first stage, each leaf of
at least 65,536 elements split along its largest dimension that N divides
(``parallel/fsdp.py``). The network's units gather their parameters as they
run, the gradients are reduce-scattered, each rank updates its slices, and
the checkpoints are the replicated run's files, gathered for rank 0 to
write. With one process ``--fsdp`` warns, as the JAX CLI does, and trains
unsharded.

Examples:
  python train_torch.py --tiny --synthetic --steps 3 --ckpt_every 0 --device cpu
  python train_torch.py --synthetic --steps 10 --freeze_type spatial --use_ema
  torchrun --nproc_per_node 8 train_torch.py --synthetic --bs 8 --dp 8 --freeze_type spatial
  torchrun --nproc_per_node 2 train_torch.py --tiny --synthetic --device cpu   # t 2
  torchrun --nproc_per_node 2 train_torch.py --tiny --synthetic --device cpu --fsdp
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional, Sequence

# (height, width) of one view and of the latent panorama: the tiny config's
# and the production geometry (train.py:115-120 of the JAX CLI)
TINY_FINAL_DIM, FULL_FINAL_DIM = (16, 32), (256, 512)
TINY_LATENT_HW, FULL_LATENT_HW = (2, 24), (32, 384)
GRAD_CLIP = 1.0
MAX_KEEP = 3


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base", nargs="*", default=["inference_nuscenes"],
                   help="configs of panacea_tpu_torch/configs.py by name "
                        "(inference_nuscenes, tiny_cpu), or YAML paths where "
                        "PyYAML is installed; later ones override earlier ones")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--ann_file", default=None)
    p.add_argument("--data_root", default="data/nuscenes/")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--dp", type=int, default=None,
                   help="clip groups (data-parallel size); each clip's frames split over "
                        "the process count / dp ranks of its group. Default, as the JAX "
                        "CLI: max(1, processes // frames), so that 2 to 'frames' "
                        "processes split one clip's frames over all of them")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: shard the network's parameters, their fp32 masters, the "
                        "optimizer state, the EMA and the first stage over all processes "
                        "(the reference trained under DeepSpeed); with one process it "
                        "warns and trains unsharded")
    p.add_argument("--freeze_type", default=None, choices=[None, "none", "spatial"])
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--ckpt_dir", default="ckpts/train")
    p.add_argument("--ckpt_every", type=int, default=500)
    p.add_argument("--resume", default=None,
                   help="an iter_N full-state checkpoint directory, or a ckpt_dir "
                        "holding them (optimizer, step, EMA and the random streams "
                        "restored for an exact continuation), or a reference .ckpt "
                        "(weights only; optimizer and step start fresh)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device; default the local rank's card, which "
                        "raises without a card. 'cpu' is for tests")
    return p


def default_loss_config(engine) -> Dict[str, Any]:
    """The loss the JAX CLI builds where the config has none (train.py:88-101)."""
    ddpm = {"target": "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization"}
    return {"target": "sgm.modules.diffusionmodules.loss.StandardDiffusionLoss",
            "params": {"sigma_sampler_config": {
                "target": "sgm.modules.diffusionmodules.sigma_sampling.DiscreteSampling",
                "params": {"num_idx": 1000, "discretization_config": ddpm}},
                "share_noise_level": engine.share_noise_level,
                "num_frames": engine.num_frames}}


def rank_rows(engine, batch: Dict[str, Any], cond: Dict[str, Any], generator, rows: slice,
              frames: slice = slice(None)):
    """One rank's part of a global step: the clips ``rows`` of the global
    batch's ``jpg`` and their frames ``frames`` (the rank's slab of each
    clip), the same clips' rows of the conditioning ``cond`` (per clip) and
    slab (per frame), and the step's random draws made from ``generator`` at
    the global batch's shape, in ``train_step``'s order (the posterior, then
    the loss's sigmas and noise), cut to the same frames; with the global
    batch's conditioning frame for the shared-noise bias. With every row
    and frame, the step is the one-process step. Returns (jpg, cond, draws
    to inject)."""
    jpg = batch["jpg"]                       # (B, T, H, W, 3)
    b, t = jpg.shape[:2]

    def per_frame(v):                        # (B * T, ...) -> this rank's frames, flat
        v = v.reshape((b, t) + tuple(v.shape[1:]))[rows, frames]
        return v.reshape((-1,) + tuple(v.shape[2:]))

    posterior = engine.draw_posterior_noise(b * t, jpg.shape[2:4], generator)
    inject = engine.loss_fn.draw(posterior.shape, generator, engine.device)
    inject = {k: per_frame(v) for k, v in inject.items()}
    inject["posterior_noise"] = per_frame(posterior)
    if "concat" in cond:
        inject["share_frame"] = cond["concat"][-1]

    def cut(k, v):
        if v.shape[0] not in (b, b * t):
            raise ValueError(f"conditioning {k!r} has {v.shape[0]} rows, neither the "
                             f"batch's {b} clips nor its {b * t} frames")
        return v[rows] if v.shape[0] == b else per_frame(v)

    return jpg[rows, frames], {k: cut(k, v) for k, v in cond.items()}, inject


def main(argv: Optional[Sequence[str]] = None, save_final: bool = True,
         fsdp_min_size: Optional[int] = None) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``). Returns a
    summary: the losses, the train state, the engine and the timer.
    ``save_final`` False leaves out the final saves (27 GB at full width),
    for callers that read the state in memory. ``fsdp_min_size`` replaces
    the 65,536 elements under which ``--fsdp`` keeps a leaf replicated (the
    JAX ``fsdp_min_size``; tests split the tiny config's small leaves)."""
    args, unknown = get_parser().parse_known_args(argv)
    from panacea_tpu_torch.parallel.mesh import FSDP_MIN_SIZE, process_group

    with process_group(args.device) as group:
        return _run(args, unknown, group, save_final, fsdp_min_size or FSDP_MIN_SIZE)


def _run(args, unknown, group, save_final: bool, fsdp_min_size: int) -> Dict[str, Any]:
    """The run of one rank (``group``: ``parallel.mesh.Group``)."""
    import numpy as np
    import torch

    from panacea_tpu_torch.checkpoint import (CHECKPOINT_SUFFIXES, ema_state,
                                              is_train_checkpoint, load_checkpoint,
                                              load_train_checkpoint, network_state,
                                              save_engine_checkpoint, save_train_checkpoint)
    from panacea_tpu_torch.config import load_configs_with_overrides
    from panacea_tpu_torch.data.nuscenes.dataset import NuScenesVideoDataset, collate
    from panacea_tpu_torch.parallel.fsdp import Shards, measured_bytes
    from panacea_tpu_torch.parallel.mesh import check_dp, make_grid
    from panacea_tpu_torch.parallel.train import assert_same, barrier, broadcast_from_rank0
    from panacea_tpu_torch.registry import instantiate_from_config
    from panacea_tpu_torch.train_step import init_train_state, train_step
    from panacea_tpu_torch.utils.profiling import Timer

    if args.tiny:
        args.base = ["tiny_cpu"]
    device = group.device
    cfg = load_configs_with_overrides(args.base, unknown)
    engine = instantiate_from_config(cfg["model"], device=device)
    if args.freeze_type:
        engine.freeze_type = args.freeze_type
    engine.loss_fn = instantiate_from_config(cfg.get("loss_fn_config")
                                             or default_loss_config(engine))
    t = engine.num_frames
    dp, t_ranks = check_dp(args.dp, group.world, t)
    if args.bs % dp:
        raise SystemExit(f"--bs {args.bs} is the global batch: it must split evenly over "
                         f"--dp {dp}")
    local_bs = args.bs // dp
    # rank (d * t_ranks + i): clip group d's clips, slab i of their frames
    d, i = divmod(group.rank, t_ranks)
    rows = slice(d * local_bs, (d + 1) * local_bs)
    slab = t // t_ranks
    frames = slice(i * slab, (i + 1) * slab)
    grid = make_grid(group.world, 1, device, dp=dp)
    engine.set_grid(grid)
    final_dim = TINY_FINAL_DIM if args.tiny else FULL_FINAL_DIM

    if args.synthetic:
        from panacea_tpu_torch.data.nuscenes.synthetic import (make_synthetic_infos,
                                                               synthetic_image_loader)

        infos = make_synthetic_infos(num_frames=max(4 * t, 16), seed=args.seed)
        dataset = NuScenesVideoDataset(infos=infos, queue_length=t, final_dim=final_dim,
                                       image_loader=synthetic_image_loader, seed=args.seed)
    else:
        ann = args.ann_file or os.path.join(args.data_root,
                                            "nuscenes2d_ego_temporal_infos_train.pkl")
        dataset = NuScenesVideoDataset(ann_file=ann, data_root=args.data_root,
                                       queue_length=t, final_dim=final_dim, seed=args.seed)

    engine.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    resume_meta: Dict[str, Any] = {}
    if args.resume and not is_train_checkpoint(args.resume):
        if not args.resume.endswith(CHECKPOINT_SUFFIXES):
            raise SystemExit(f"--resume {args.resume}: neither an iter_N checkpoint "
                             f"(directory) nor a {'/'.join(CHECKPOINT_SUFFIXES)} file")
        # weights-only warm start; the optimizer and the step start fresh
        print(f"[resume] weights {load_checkpoint(args.resume, engine)}", flush=True)
    fsdp = args.fsdp and group.world > 1
    if args.fsdp and not fsdp:
        print("WARNING: --fsdp ignored: needs a multi-device mesh (have 1 device); "
              "training state stays replicated", flush=True)
    if fsdp:
        # one set of parameters on every rank before they are split (the
        # frozen ones come from the same seed or checkpoint: checked, not sent)
        trained = engine.set_trainable()
        broadcast_from_rank0(list(trained.values()))
        assert_same([p for k, p in engine.named_parameters() if k not in trained])
        Shards(engine, group.rank, group.world, group.backend, min_size=fsdp_min_size)
    state = init_train_state(engine, lr=args.lr, grad_clip=GRAD_CLIP, use_ema=args.use_ema)
    if args.resume and is_train_checkpoint(args.resume):
        resume_meta = load_train_checkpoint(args.resume, state, engine)
        print(f"[resume] {resume_meta['path']} -> step {state.step}", flush=True)
    if group.backend is not None and not fsdp:
        # one set of parameters on every rank, as DDP starts (the frozen ones
        # come from the same seed or checkpoint: checked, not sent)
        broadcast_from_rank0(list(state.params.values()))
        state.sync_network()
        assert_same([p for k, p in engine.named_parameters() if k not in state.params])
    if fsdp:
        sh = engine.shards
        print(f"fsdp: {len(sh.leaves)} of {len(sh.dims)} leaves split over {group.world} "
              f"ranks (at least {sh.min_size} elements), "
              f"{sum(sh.numel[k] for k in sh.leaves)} of {sum(sh.numel.values())} "
              "parameters of the network and the first stage; state a rank "
              f"{measured_bytes(state, engine)['total'] / 1e9:.3f} GB", flush=True)
    n_trained = sum(p.numel() for p in state.params.values())
    print(f"rank={group.rank}/{group.world} backend={group.backend} device={device} "
          f"trained parameters={n_trained} freeze_type={engine.freeze_type} "
          f"ema={args.use_ema} batch={args.bs} grid dp={dp} t={t_ranks} ({local_bs} clips "
          f"and frames {frames.start}-{frames.stop - 1} a rank)", flush=True)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    rs = np.random.RandomState(args.seed)
    if "generator" in resume_meta:
        generator.set_state(resume_meta["generator"])
        rs.set_state(resume_meta["rs_state"])
        # the dataset's own random.Random words the prompts and shuffles the
        # views per item: restored, the data stream replays the uninterrupted one
        dataset.rng.setstate(resume_meta["ds_rng_state"])

    timer = Timer(device)
    losses = []
    start = state.step
    t0 = time.time()
    for step in range(start, args.steps):
        # the global batch's clips, the same on every rank (train.py:204)
        idxs = rs.randint(t - 1, len(dataset), args.bs)
        with timer("dataset"):
            # every rank reads the whole global batch, as the JAX CLI's
            # processes do (train.py:204-205): the dataset's own random.Random
            # (prompt wording, view order) then advances alike on every rank
            batch = collate([dataset[int(i)] for i in idxs])
        with timer("conditioning"), torch.no_grad():
            cond = engine.conditioner(batch, device, generator=generator, apply_ucg=True)
            jpg, cond, draws = rank_rows(engine, batch, cond, generator, rows, frames)
        loss = float(train_step(engine, state, jpg, cond, timer=timer, **draws))
        losses.append(loss)
        if step % args.log_every == 0 and group.rank == 0:
            dt = (time.time() - t0) / max(step - start, 1)
            print(f"step {step} loss {loss:.4f} ({dt:.2f}s/it)", flush=True)
        if args.ckpt_every > 0 and state.step % args.ckpt_every == 0:
            if group.rank == 0 or fsdp:    # under --fsdp every rank gathers, rank 0 writes
                meta = {"generator": generator.get_state(), "rs_state": rs.get_state(),
                        "ds_rng_state": dataset.rng.getstate()}
                save_train_checkpoint(args.ckpt_dir, state, engine, meta, max_keep=MAX_KEEP)
            barrier()
    path = os.path.join(args.ckpt_dir, "engine_final.ckpt")
    if save_final and (group.rank == 0 or fsdp):
        final, shadows = network_state(state, engine), ema_state(state)
        if group.rank == 0:
            os.makedirs(args.ckpt_dir, exist_ok=True)
            torch.save(final, os.path.join(args.ckpt_dir, "final.pt"))
            if shadows is not None:
                torch.save(shadows, os.path.join(args.ckpt_dir, "final_ema.pt"))
        del final, shadows
        # train -> inference: a reference-style checkpoint of the whole engine,
        # with the EMA shadows where the EMA is on (inference_torch.py --ckpt
        # ... --prefer_ema samples from them, as the reference samples from model_ema)
        path = save_engine_checkpoint(path, engine, state=state, ema=state.ema)
        if group.rank == 0:
            print(f"training done -> {path}", flush=True)
    barrier()
    return {"losses": losses, "state": state, "engine": engine, "timer": timer,
            "engine_ckpt": path, "grid": grid, "slab": (rows, frames)}
