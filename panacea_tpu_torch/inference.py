"""Inference entry point of the port (counterpart of the JAX package's root
``inference.py``; reference inference.py:230-318).

The same CLI surface (--base/--ckpt/--split/--name/--bs/--use_last_frame and
dotlist overrides) and the same output layout, ``<outdir>/<name>/<split>/``
with a folder of PNG grids and GIFs per log key, the ``gen-nuscenes`` JPEG
tree and, with ``--rollout``, ``rollout/<stem>/``. One process drives one
card. It runs on CUDA and raises without a card; ``--device cpu`` is for
tests.

Examples:
  python inference_torch.py --ckpt ckpts/panaceaplus_40k_deepspeed.ckpt \\
      --split val --name panacea
  python inference_torch.py --synthetic --tiny --device cpu --num_batches 1
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional, Sequence

# (height, width) of one view: the tiny config's and the production geometry
TINY_FINAL_DIM, FULL_FINAL_DIM = (16, 192 // 6), (256, 512)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base", nargs="*", default=["inference_nuscenes"],
                   help="configs of panacea_tpu_torch/configs.py by name "
                        "(inference_nuscenes, tiny_cpu), or YAML paths where "
                        "PyYAML is installed; later ones override earlier ones")
    p.add_argument("--ckpt", "--ckptpath", dest="ckpt", default=None)
    p.add_argument("--split", default="val", choices=["train", "val"])
    p.add_argument("--name", default="panacea_tpu")
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--use_last_frame", action="store_true", default=True)
    p.add_argument("--use_first_frame", dest="use_last_frame",
                   action="store_false")
    p.add_argument("--outdir", default="outputs")
    p.add_argument("--ann_file", default=None)
    p.add_argument("--data_root", default="data/nuscenes/")
    p.add_argument("--num_batches", type=int, default=-1)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--synthetic", action="store_true",
                   help="run on generated synthetic scenes (no dataset needed)")
    p.add_argument("--tiny", action="store_true",
                   help="use the tiny config (smoke testing); the device "
                        "stays the one --device names")
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--prefer_ema", action="store_true",
                   help="load model_ema.* shadow weights instead of raw")
    p.add_argument("--rollout", type=int, default=0,
                   help="autoregressive long-video mode: generate N "
                        "overlapping windows per clip (the reference's "
                        "last-frame-conditioning pipeline, README.md:85-88) "
                        "and write a stitched long video per sample. NOTE: "
                        "any N >= 1 (including 1) uses the rollout gif/jpg "
                        "output layout, not the standard log_images grids; "
                        "use --rollout 0 (default) for grids")
    p.add_argument("--view_shard", type=int, default=0,
                   help="shard ONE clip over the local devices; not ported: "
                        "any value above 0 raises")
    p.add_argument("--dry_convert", nargs="?", default=None,
                   const="tests/fixtures/panaceaplus_keys.json",
                   help="checkpoint-readiness drill: given a state-dict KEY "
                        "list (json {key: shape}, default the panaceaplus "
                        "list from scripts/dump_reference_keys.py) or a real "
                        ".ckpt, report name and shape coverage against the "
                        "engine (0 unmapped / 0 missing) and exit")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda, which raises without a "
                        "card. 'cpu' is for tests")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``). Returns a summary:
    the output directory, the number of clips or rollouts done, and the
    phase timer."""
    args, unknown = get_parser().parse_known_args(argv)

    import numpy as np
    import torch

    from panacea_tpu_torch.config import load_configs_with_overrides
    from panacea_tpu_torch.data.nuscenes.dataset import NuScenesVideoDataset, collate
    from panacea_tpu_torch.models.engine import resolve_device
    from panacea_tpu_torch.registry import instantiate_from_config
    from panacea_tpu_torch.utils.profiling import Timer
    from panacea_tpu_torch.writers import log_outputs

    if args.tiny:
        args.base = ["tiny_cpu"]
    if args.view_shard:
        raise SystemExit(
            f"--view_shard {args.view_shard}: sharding one clip over several "
            "devices is not ported; run without it (one clip on one card)")
    if args.dry_convert:
        from panacea_tpu_torch.checkpoint import dry_convert

        cfg = load_configs_with_overrides(args.base, unknown)
        engine = instantiate_from_config(cfg["model"], device="meta")
        raise SystemExit(dry_convert(engine, args.dry_convert))
    if not args.synthetic:
        # real inference with hash-fallback token ids would silently generate
        # garbage; refuse unless the BPE merge table is present
        from panacea_tpu_torch.data.tokenizer import has_real_vocab

        if not has_real_vocab():
            raise SystemExit(
                "CLIP BPE merge table not found: real text conditioning is "
                "impossible (the tokenizer would fall back to hash ids). "
                "Set PANACEA_CLIP_BPE=/path/to/bpe_simple_vocab_16e6.txt.gz "
                "or run with --synthetic for a smoke test."
            )
    device = resolve_device(args.device)  # raises without a card unless told otherwise
    cfg = load_configs_with_overrides(args.base, unknown)
    engine = instantiate_from_config(cfg["model"], device=device)
    t = engine.num_frames
    final_dim = TINY_FINAL_DIM if args.tiny else FULL_FINAL_DIM

    if args.synthetic:
        from panacea_tpu_torch.data.nuscenes.synthetic import (
            make_synthetic_infos,
            synthetic_image_loader,
        )

        infos = make_synthetic_infos(num_frames=max(t, 2) * 4, seed=args.seed)
        dataset = NuScenesVideoDataset(
            infos=infos, queue_length=t, final_dim=final_dim,
            use_last_frame=args.use_last_frame,
            image_loader=synthetic_image_loader, seed=args.seed,
        )
    else:
        ann = args.ann_file or os.path.join(
            args.data_root,
            f"nuscenes2d_ego_temporal_infos_{args.split}.pkl",
        )
        dataset = NuScenesVideoDataset(
            ann_file=ann, data_root=args.data_root, queue_length=t,
            final_dim=final_dim, use_last_frame=args.use_last_frame,
            seed=args.seed,
        )

    engine.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    if args.ckpt:
        from panacea_tpu_torch.checkpoint import CHECKPOINT_SUFFIXES, load_checkpoint

        if not args.ckpt.endswith(CHECKPOINT_SUFFIXES):
            raise SystemExit(
                f"--ckpt {args.ckpt}: the port loads reference checkpoints "
                f"({', '.join(CHECKPOINT_SUFFIXES)}); the JAX package's own "
                "checkpoint trees are not ported")
        report = load_checkpoint(args.ckpt, engine, prefer_ema=args.prefer_ema)
        print(f"[ckpt] {args.ckpt}: {report}", flush=True)

    outdir = os.path.join(args.outdir, args.name, args.split)
    os.makedirs(outdir, exist_ok=True)

    n_total = len(dataset) // max(t, 1)
    indices = [t - 1 + i * t for i in range(n_total)]
    if args.num_batches > 0:
        indices = indices[: args.num_batches * args.bs]

    def generator(offset: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(args.seed + offset)

    timer = Timer(device)
    n_done = 0
    if args.rollout >= 1:
        # autoregressive long-video pipeline (panacea_tpu_torch/rollout.py)
        from PIL import Image

        from panacea_tpu_torch.rollout import rollout
        from panacea_tpu_torch.writers import save_gif, to_uint8

        for start, idx in enumerate(indices):
            with timer("rollout"):
                out = rollout(engine, dataset, idx, args.rollout,
                              generator=generator(start), num_steps=args.num_steps)
            frames = out["frames"]  # (N_total, H, 6*W, 3) in [-1, 1]
            stem = os.path.basename(
                str(out["filenames"][-1][0])).rsplit(".", 1)[0]
            rdir = os.path.join(outdir, "rollout", stem)
            os.makedirs(rdir, exist_ok=True)
            with timer("write"):
                save_gif(frames, os.path.join(rdir, "long.gif"), fps=4.0)
                u8 = to_uint8(frames)
                for fi in range(len(u8)):
                    Image.fromarray(u8[fi]).save(
                        os.path.join(rdir, f"frame_{fi:04d}.jpg"))
            n_done += 1
            print(f"[rollout {n_done}] {len(frames)} frames "
                  f"{timer.report()}", flush=True)
        print(f"done: {n_done} rollouts -> {outdir}/rollout")
        return {"outdir": outdir, "done": n_done, "timer": timer}
    for start in range(0, len(indices), args.bs):
        chunk = indices[start:start + args.bs]
        with timer("dataset"):
            batch = collate([dataset[i] for i in chunk])
        with timer("clip"):
            log = engine.log_images(
                batch, N=args.bs, generator=generator(start),
                num_steps=args.num_steps,
            )
        with timer("to_host"):
            log = {k: np.asarray(v.float().cpu()) for k, v in log.items()}
        with timer("write"):
            log_outputs(log, outdir, batch["filenames"][0], num_frames=t,
                        view_width=final_dim[1])
        n_done += len(chunk)
        print(f"[{n_done}] {timer.report()}", flush=True)
    print(f"done: {n_done} clips -> {outdir}")
    return {"outdir": outdir, "done": n_done, "timer": timer}
