"""Training entry point of the port (counterpart of the JAX package's root
``train.py``): the generator trained with the diffusion loss on one card.

The JAX CLI's flags and defaults, plus ``--device`` (the card by default;
``--device cpu`` for tests). One step: a batch of clips picked with the JAX
CLI's ``np.random.RandomState(seed).randint(t - 1, len, bs)`` (so both CLIs
read the same clips), the conditioning with ucg dropout, and
``train_step.train_step``. Every ``--ckpt_every`` steps a rotating full-state
checkpoint ``{ckpt_dir}/iter_N`` (``--resume`` continues from it exactly);
at the end ``final.pt`` (the network's parameters, fp32), ``final_ema.pt``
(the EMA shadows, with ``--use_ema``) and ``engine_final.ckpt``, a reference
style checkpoint that ``inference_torch.py --ckpt`` loads (``--prefer_ema``
for the shadows). ``--fsdp`` and ``--dp > 1`` raise: multi-device training is
not ported.

Examples:
  python train_torch.py --tiny --synthetic --steps 3 --ckpt_every 0 --device cpu
  python train_torch.py --synthetic --steps 10 --freeze_type spatial --use_ema
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
MULTI_DEVICE = ("multi-device training is not ported (ROADMAP.md, Queue A item 7); "
                "run on one device without --fsdp and --dp")


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
                   help="data-parallel size; only 1 is ported (more raises)")
    p.add_argument("--fsdp", action="store_true",
                   help="sharded training state; not ported (raises)")
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
                   help="torch device; default cuda, which raises without a "
                        "card. 'cpu' is for tests")
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


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``). Returns a
    summary: the losses, the train state, the engine and the timer."""
    args, unknown = get_parser().parse_known_args(argv)
    if args.fsdp or (args.dp or 1) > 1:
        raise SystemExit(f"--fsdp / --dp {args.dp}: {MULTI_DEVICE}")

    import numpy as np
    import torch

    from panacea_tpu_torch.checkpoint import (CHECKPOINT_SUFFIXES, is_train_checkpoint,
                                              load_checkpoint, load_train_checkpoint,
                                              save_engine_checkpoint, save_train_checkpoint)
    from panacea_tpu_torch.config import load_configs_with_overrides
    from panacea_tpu_torch.data.nuscenes.dataset import NuScenesVideoDataset, collate
    from panacea_tpu_torch.models.engine import resolve_device
    from panacea_tpu_torch.registry import instantiate_from_config
    from panacea_tpu_torch.train_step import init_train_state, train_step
    from panacea_tpu_torch.utils.profiling import Timer

    if args.tiny:
        args.base = ["tiny_cpu"]
    device = resolve_device(args.device)  # raises without a card unless told otherwise
    cfg = load_configs_with_overrides(args.base, unknown)
    engine = instantiate_from_config(cfg["model"], device=device)
    if args.freeze_type:
        engine.freeze_type = args.freeze_type
    engine.loss_fn = instantiate_from_config(cfg.get("loss_fn_config")
                                             or default_loss_config(engine))
    t = engine.num_frames
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
    state = init_train_state(engine, lr=args.lr, grad_clip=GRAD_CLIP, use_ema=args.use_ema)
    if args.resume and is_train_checkpoint(args.resume):
        resume_meta = load_train_checkpoint(args.resume, state, engine)
        print(f"[resume] {resume_meta['path']} -> step {state.step}", flush=True)
    n_trained = sum(p.numel() for p in state.params.values())
    print(f"device={device} trained parameters={n_trained} freeze_type={engine.freeze_type} "
          f"ema={args.use_ema}", flush=True)

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
        idxs = rs.randint(t - 1, len(dataset), args.bs)  # as the JAX CLI (train.py:204)
        with timer("dataset"):
            batch = collate([dataset[int(i)] for i in idxs])
        with timer("conditioning"), torch.no_grad():
            cond = engine.conditioner(batch, device, generator=generator, apply_ucg=True)
        loss = float(train_step(engine, state, batch["jpg"], cond, generator, timer=timer))
        losses.append(loss)
        if step % args.log_every == 0:
            dt = (time.time() - t0) / max(step - start, 1)
            print(f"step {step} loss {loss:.4f} ({dt:.2f}s/it)", flush=True)
        if args.ckpt_every > 0 and state.step % args.ckpt_every == 0:
            meta = {"generator": generator.get_state(), "rs_state": rs.get_state(),
                    "ds_rng_state": dataset.rng.getstate()}
            save_train_checkpoint(args.ckpt_dir, state, engine, meta, max_keep=MAX_KEEP)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    final = {f"model.{n}": state.params.get(f"model.{n}", p).detach().float().cpu()
             for n, p in engine.model.named_parameters()}
    torch.save(final, os.path.join(args.ckpt_dir, "final.pt"))
    if state.ema is not None:
        torch.save({k: v.cpu() for k, v in state.ema.shadows.items()},
                   os.path.join(args.ckpt_dir, "final_ema.pt"))
    # train -> inference: a reference-style checkpoint of the whole engine,
    # with the EMA shadows where the EMA is on (inference_torch.py --ckpt
    # ... --prefer_ema samples from them, as the reference samples from model_ema)
    path = save_engine_checkpoint(os.path.join(args.ckpt_dir, "engine_final.ckpt"), engine,
                                  state=state, ema=state.ema)
    print(f"training done -> {path}", flush=True)
    return {"losses": losses, "state": state, "engine": engine, "timer": timer,
            "engine_ckpt": path}
