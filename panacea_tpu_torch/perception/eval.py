"""Perception eval of the port: StreamPETRWindow on Gen-nuScenes (or real)
frames -> NDS/mAP.

Counterpart of the JAX package's root ``eval_perception.py``, with its
flags, choices and defaults, and ``--device``. One process drives one card;
it runs on CUDA and raises without a card, ``--device cpu`` is for tests.
The eval recipe's detector (``--backbone r50 --head sparse``) and the
dense-attention PETR family (``--backbone vovnet``, ``--head petr``,
``petr_dn`` or ``motion``) are ported; ``--backbone eva`` and ``--head
sparse_v3|sparse_v4`` raise and name ROADMAP Queue A item 6.
``--torch_ckpt`` loads a reference mmdet ``.pth`` straight into the port
(the names are the same, VoVNet's and the PETR heads' included), leaving
what it does not cover at the random init, as the JAX CLI merges its
converted tree.

  python eval_perception_torch.py --ann data/nuscenes/nuscenes2d_ego_temporal_infos_val.pkl \\
      --gen_root outputs/panacea_tpu/val/gen-nuscenes --torch_ckpt streampetr.pth
  python eval_perception_torch.py --synthetic --tiny --device cpu
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ann", default=None)
    p.add_argument("--gen_root", default=None,
                   help="Gen-nuScenes root; omit to eval on real frames")
    p.add_argument("--data_root", default="data/nuscenes/")
    p.add_argument("--ckpt", default=None,
                   help="orbax detector checkpoint of the JAX package; not "
                        "ported (reading it needs JAX): use --torch_ckpt")
    p.add_argument("--num_samples", type=int, default=-1)
    p.add_argument("--queue_length", type=int, default=8)
    p.add_argument("--out", default=None, help="write metrics json here")
    p.add_argument("--backbone", default="r50", choices=["r50", "vovnet", "eva"],
                   help="img_backbone family; eva is not ported")
    p.add_argument("--head", default="sparse",
                   choices=["sparse", "petr", "sparse_v3", "sparse_v4", "motion", "petr_dn"],
                   help="detection head family; sparse_v3 and sparse_v4 are not ported")
    p.add_argument("--torch_ckpt", default=None,
                   help="reference mmdet .pth (a 'state_dict' inside, or bare), "
                        "loaded non-strictly under its own names")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic infos + images (no nuScenes needed); "
                        "with --gen_root, synthetic infos but REAL generated "
                        "frames from that root (the gen->eval round trip)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny detector dims (smoke); the device stays the one "
                        "--device names")
    p.add_argument("--final_dim", type=int, nargs=2, default=None,
                   help="override eval image H W (e.g. to match a tiny "
                        "generation run)")
    p.add_argument("--num_levels", type=int, default=None,
                   help="override FPN levels (small final_dim needs fewer)")
    p.add_argument("--seed", type=int, default=0,
                   help="synthetic-infos seed (must match the generation "
                        "run's --seed for the round trip)")
    p.add_argument("--gen_clip_len", type=int, default=None,
                   help="clip length of a DISJOINT-clip generation run; "
                        "evaluates only at clip-end key frames with "
                        "clip-aligned frame offsets so each history image "
                        "pairs with the calib/ego-pose of the sample it was "
                        "generated for")
    p.add_argument("--filter_file", default=None,
                   help="pkl list of sample tokens to keep (reference "
                        "filter_file)")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda, which raises without a "
                        "card. 'cpu' is for tests")
    return p


def load_reference_checkpoint(model, path: str) -> Dict[str, int]:
    """A StreamPETR ``.pth`` into ``model``, strict=False: tensors whose name
    and shape the model has are copied, the rest stay at init. Returns the
    counts of restored, missing and unexpected tensors."""
    from panacea_tpu_torch.checkpoint import load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    own = model.state_dict()
    fit = {k: v for k, v in sd.items() if k in own and own[k].shape == v.shape}
    model.load_state_dict(fit, strict=False)
    report = {"restored": len(fit), "missing": sum(k not in fit for k in own),
              "unexpected": sum(k not in fit for k in sd)}
    print(f"StreamPETR restore: {report['missing']} missing, "
          f"{report['unexpected']} unexpected")
    print(f"restored {report['restored']} tensors from {path}")
    return report


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    metrics it printed (on rank 0; an empty dict on the other ranks)."""
    args = get_parser().parse_args(argv)
    if args.ckpt:
        raise SystemExit(
            f"--ckpt {args.ckpt}: the JAX package's orbax trees need JAX to read, "
            "which the port does not use (ROADMAP 'Not queued'); pass the "
            "reference .pth as --torch_ckpt")

    import numpy as np
    import torch
    import torch.distributed as dist

    from panacea_tpu_torch.models.engine import resolve_device
    from panacea_tpu_torch.perception.coder import NMSFreeCoder
    from panacea_tpu_torch.perception.collect import collect_results_cpu
    from panacea_tpu_torch.perception.detector import StreamPETRWindow
    from panacea_tpu_torch.perception.eval_dataset import GenNuScenesEvalDataset
    from panacea_tpu_torch.perception.metrics import CLASS_NAMES, evaluate_detections

    device = resolve_device(args.device)  # raises without a card unless told otherwise
    if args.synthetic:
        from panacea_tpu_torch.data.nuscenes.synthetic import make_synthetic_infos

        infos = make_synthetic_infos(num_frames=8, num_boxes=6, seed=args.seed)
        for info in infos:
            info["ego2global_rotation"] = [1.0, 0.0, 0.0, 0.0]
            info["ego2global_translation"] = [2.0 * info["frame_idx"], 0.0, 0.0]
        if args.gen_clip_len:
            # the full infos (history frames keep their own calibration and
            # pose); the dataset evaluates only at clip-end key frames
            args.queue_length = min(args.queue_length, args.gen_clip_len)
        final_dim = tuple(args.final_dim or ((64, 128) if args.tiny else (256, 512)))
        if args.gen_root:
            # the round trip: the generation run's synthetic infos, its frames
            # read from its Gen-nuScenes tree
            loader = None
        else:
            def loader(path):
                from panacea_tpu_torch.data.nuscenes.synthetic import path_seed

                rs = np.random.RandomState(path_seed(path))
                return rs.uniform(0, 255, final_dim + (3,)).astype(np.float32)

        ds = GenNuScenesEvalDataset(infos=infos, gen_root=args.gen_root,
                                    queue_length=min(args.queue_length, 4),
                                    final_dim=final_dim, image_loader=loader,
                                    gen_clip_len=args.gen_clip_len)
    else:
        filter_tokens = None
        if args.filter_file:
            # {'infos': [{'token', 'timestamp', ...}]} pkl (nuscenes_dataset.py:101-112)
            import pickle

            with open(args.filter_file, "rb") as f:
                fd = pickle.load(f)
            fi = fd["infos"] if isinstance(fd, dict) else fd
            filter_tokens = [e["token"] if isinstance(e, dict) else e for e in fi]
        ds = GenNuScenesEvalDataset(
            ann_file=args.ann, gen_root=args.gen_root, data_root=args.data_root,
            queue_length=args.queue_length, filter_tokens=filter_tokens,
            **({"final_dim": tuple(args.final_dim)} if args.final_dim else {}))
    zoo = dict(backbone_type=args.backbone, head_type=args.head,
               neck_start_level={"r50": 1, "vovnet": 2, "eva": 0}[args.backbone])
    if args.num_levels:
        zoo["num_levels"] = args.num_levels
    if args.tiny:
        zoo.update(embed_dims=32, num_query=12, memory_len=24, topk_proposals=8,
                   num_propagated=8, num_decoder_layers=2, num_cams=6)
    model = StreamPETRWindow(**zoo).to(device).eval()
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    if args.torch_ckpt:
        load_reference_checkpoint(model, args.torch_ckpt)

    coder = NMSFreeCoder(pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                         max_num=20 if args.tiny else 300)
    distributed = dist.is_available() and dist.is_initialized()
    proc, nproc = (dist.get_rank(), dist.get_world_size()) if distributed else (0, 1)
    preds, gts = [], []
    n = 0
    t0 = time.time()
    for i in range(proc, len(ds), nproc):
        window = ds.sliding_window(i)
        if window is None:
            continue
        window = {k: torch.as_tensor(v, device=device) for k, v in window.items()}
        imgs = window.pop("imgs")
        with torch.inference_mode():
            outs, _ = model(imgs, window)
        dets = coder.decode(outs)[0]
        preds.append((i, {"boxes": dets["bboxes"], "labels": dets["labels"],
                          "scores": dets["scores"]}))
        gts.append((i, ds.gt_for(i, list(CLASS_NAMES))))
        n += 1
        if n % 50 == 0:
            print(f"[{n}] {(time.time() - t0) / n:.2f}s/sample", flush=True)
        if args.num_samples > 0 and n >= args.num_samples:
            break

    # merge the shards of the processes (collect_results_cpu); rank 0 scores
    tmpdir = (args.out or "eval_perception") + ".collect"
    preds = collect_results_cpu(preds, tmpdir, proc, nproc)
    gts = collect_results_cpu(gts, tmpdir + "_gt", proc, nproc)
    if proc != 0:
        return {}
    metrics = evaluate_detections(preds, gts)
    if args.gen_root:
        # layout-contract accounting: a writer/reader dir-naming drift would
        # otherwise be zero-filled without a word
        metrics["gen_frames_loaded"] = float(ds.gen_hits)
        metrics["gen_frames_missing"] = float(ds.gen_misses)
    print(json.dumps({k: round(float(v), 4) for k, v in metrics.items()}, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f)
    return metrics
