"""Perception (StreamPETR) training CLI of the port.

Counterpart of the JAX package's root ``train_perception.py`` (reference
tools/train.py over the recipes of ``panacea_tpu/configs/perception``),
with its flags and defaults, and ``--device``. One process drives one card;
it runs on CUDA and raises without a card, ``--device cpu`` is for tests.
Under ``torchrun --nproc_per_node N`` the run is data-parallel (the JAX
CLI's ``dp`` mesh, the reference's DDP): each rank trains on its own
``--batch`` windows, every N-th of the training windows (or its slots of
the streaming sampler), with its own GridMask, DN and augmentation draws;
the loss's avg factors and the gradients are averaged over the ranks, so
the step is the one of the global batch of N x ``--batch``. Rank 0 writes
the checkpoints (with every rank's cursor and draw states), ``final.pt``,
``train_log.json`` and the eval hook's result. ``PANACEA_PERCEPTION_DP``,
with which the JAX CLI makes a ``dp`` mesh of one process's devices, gives
dp 1 here: the port has one device a process.
``--config`` names one of the four recipes of ``configs.PERCEPTION`` (by
file name, or by the JAX package's path), or a YAML file where PyYAML
imports. The window recipes train ``StreamPETRWindow`` on sliding windows;
the streaming ones (``seq_mode``) train ``StreamPETR`` one frame a step,
the memory carried across steps through scene-continuous sample streams.
The detector is the recipe's (r50 + SparseHead), or what a YAML's
``perception.detector.params`` name: VoVNet-99 (``backbone_type: vovnet``,
``neck_start_level: 2``) and the dense PETR heads (``head_type: petr``,
``petr_dn`` or ``motion``), EVA-02 (``backbone_type: eva``, ``num_levels:
4``, its position table at the training images' grid; nothing of it is
frozen, and it takes the backbone's learning-rate multiplier) and the
proposal-query heads (``head_type: sparse_v3`` or ``sparse_v4``); with the
motion head the windows carry the ground truth's future trajectories
(``head_cfg.pred_steps``, 12 by default) and the loss its trajectory term.

Checkpoints are ``<workdir>/<recipe>/iter_N/state.pt`` (the newest 3 kept):
the detector's state, the optimizer, the step, the draw generator's state,
the dataset's ``RandomState``, the window cursor or the sampler's draw
count, and in streaming mode the memory, so ``--resume`` continues the run
as it would have gone on. At the end ``final.pt`` (the detector's state
dict, mmdet names) and ``train_log.json`` with the JAX CLI's keys.
``--load_from`` takes an mmdet ``.pth`` / ``.ckpt`` or the port's own
``final.pt`` (also named without its suffix, as the finetune recipe names
the pretrain run's ``final``), loaded non-strictly; a missing path warns
and trains from scratch, as the JAX CLI does.

Images are normalised once, by the dataset (``eval_dataset.frame_inputs``);
the JAX CLI normalises them a second time (ROADMAP Queue C).

  python train_perception_torch.py --config streampetr_r50_atss_512x256_window
  python train_perception_torch.py --synthetic --tiny --steps 2 --device cpu
  torchrun --nproc_per_node 8 train_perception_torch.py --batch 2
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional, Sequence

NOT_QUEUED = ("is a JAX orbax tree, which needs JAX to read; the port does not use JAX "
              "(ROADMAP 'Not queued')")
MAX_KEEP = 3
TINY = dict(embed_dims=32, num_query=12, memory_len=24, topk_proposals=8, num_propagated=8,
            num_decoder_layers=2, atss_stacked_convs=1)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config",
                   default="panacea_tpu/configs/perception/"
                           "streampetr_r50_atss_512x256_window.yaml",
                   help="a recipe of configs.PERCEPTION by file name or path, or a YAML file")
    p.add_argument("--steps", type=int, default=-1,
                   help="override total iterations (-1: config epochs)")
    p.add_argument("--ckpt_every", type=int, default=2000)
    p.add_argument("--resume", default=None,
                   help="an iter_N checkpoint directory, or the workdir holding them")
    p.add_argument("--eval_every", type=int, default=0,
                   help="NDS/mAP on --eval_samples held-out windows every N steps")
    p.add_argument("--eval_samples", type=int, default=8)
    p.add_argument("--workdir", default="work_dirs")
    p.add_argument("--max_gt", type=int, default=64)
    p.add_argument("--batch", type=int, default=0,
                   help="batch size of one rank (0: the config's batch_size, --tiny 1); "
                        "the global batch is this times the number of ranks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="tiny head widths and 64 x 128 images (smoke); the device stays "
                        "the one --device names")
    p.add_argument("--gen_root", default=None,
                   help="train on a Gen-nuScenes tree (the pseudo-pretrain recipe)")
    p.add_argument("--gen_clip_len", type=int, default=None,
                   help="frames per generated clip in --gen_root")
    p.add_argument("--final_dim", type=int, nargs=2, default=None,
                   help="override image geometry (H W)")
    p.add_argument("--num_levels", type=int, default=None,
                   help="override FPN output levels (small geometries)")
    p.add_argument("--queue_length", type=int, default=None,
                   help="override the config's sliding-window length")
    p.add_argument("--load_from", default=None, help="override the config's load_from")
    p.add_argument("--filter_file", default=None,
                   help="infos pkl restricting the training pool to its tokens")
    p.add_argument("--device", default=None,
                   help="torch device; default the local rank's card, which raises "
                        "without a card. 'cpu' is for tests")
    return p


def load_init(model, path: str) -> Optional[Dict[str, Any]]:
    """``load_from``: an mmdet ``.pth`` / ``.ckpt`` or the port's ``.pt``
    state dict, strict=False (tensors whose name and shape the detector has
    are copied: the port's names are mmdet's, so the detector built with
    its backbone and head picks what the JAX CLI's converter picks).
    Returns the JAX CLI's report, or None where nothing is found (a
    warning; training starts from the random init)."""
    from panacea_tpu_torch.perception.eval import load_reference_checkpoint

    if not os.path.exists(path) and os.path.isfile(path + ".pt"):
        path = path + ".pt"      # the port's own final, named as the recipes name it
    if os.path.isdir(path):
        raise SystemExit(f"load_from {path} {NOT_QUEUED}")
    if not os.path.exists(path):
        print(f"[warn] load_from {path} not found; training from scratch", flush=True)
        return None
    report = load_reference_checkpoint(model, path)
    print(f"merged {report['restored']} pretrained tensors from {path}"
          + (f" ({report['unexpected']} skipped: shape/path mismatch)"
             if report["unexpected"] else ""), flush=True)
    return {"path": path, "n_loaded": report["restored"], "n_skipped": report["unexpected"]}


def resume_path(path: str) -> str:
    """The iter_N directory to resume from: ``path`` itself or the newest
    under it. An orbax tree of the JAX CLI is refused."""
    from panacea_tpu_torch.checkpoint import _ITER_RE, _STATE_FILE, latest_checkpoint

    path = os.path.abspath(path)
    if not _ITER_RE.match(os.path.basename(path)):
        newest = latest_checkpoint(path)
        if newest is None:
            if os.path.isdir(path) and any(_ITER_RE.match(n) for n in os.listdir(path)):
                raise SystemExit(f"--resume {path} {NOT_QUEUED}")
            raise FileNotFoundError(f"no iter_* checkpoint under {path}")
        path = newest
    if not os.path.isfile(os.path.join(path, _STATE_FILE)):
        raise SystemExit(f"--resume {path} {NOT_QUEUED}")
    return path


def save_checkpoint(outdir: str, state, meta: Dict[str, Any]) -> str:
    """``{outdir}/iter_{step}/state.pt``; all but the newest MAX_KEEP removed."""
    import shutil

    import torch

    from panacea_tpu_torch.checkpoint import _STATE_FILE, _iter_checkpoints

    path = os.path.join(os.path.abspath(outdir), f"iter_{state.step}")
    os.makedirs(path, exist_ok=True)
    blob = {"model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(), "step": state.step, "meta": meta}
    tmp = os.path.join(path, _STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    for _, old in _iter_checkpoints(outdir)[:-MAX_KEEP]:
        shutil.rmtree(old, ignore_errors=True)
    return path


def collate(items, anchors, device):
    """``window_with_gt`` items -> one batch on ``device``: (imgs (B, T, N,
    H, W, 3), data with leading (B, T), gt_boxes (B, G, 9), gt_labels (B,
    G), the ATSS targets of the last frames' B N images, gt_trajs and
    gt_traj_mask (B, G, S, 2) where the items carry them, else None)."""
    import numpy as np
    import torch

    from panacea_tpu_torch.perception.train import atss_targets

    windows = [dict(it[0]) for it in items]
    imgs = torch.as_tensor(np.concatenate([w.pop("imgs") for w in windows], 0), device=device)
    data = {k: torch.as_tensor(np.concatenate([w[k] for w in windows], 0), device=device)
            for k in windows[0]}
    gt_boxes = torch.as_tensor(np.concatenate([it[1] for it in items], 0), device=device)
    gt_labels = torch.as_tensor(np.concatenate([it[2] for it in items], 0), device=device)
    tgt2d = atss_targets(anchors, sum((list(it[3]) for it in items), []),
                         sum((list(it[4]) for it in items), []))
    trajs = [None, None]
    if len(items[0]) > 5:
        trajs = [torch.as_tensor(np.concatenate([it[i] for it in items], 0), device=device)
                 for i in (5, 6)]
    return (imgs, data, gt_boxes, gt_labels, tgt2d, *trajs)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``). Returns the
    train log it wrote (rank 0's), with the run's ``state`` and ``outdir``."""
    args = get_parser().parse_args(argv)
    from panacea_tpu_torch.parallel.mesh import process_group

    with process_group(args.device) as group:
        return _run(args, group)


def _run(args, group) -> Dict[str, Any]:
    """The run of one rank (``group``: ``parallel.mesh.Group``)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from panacea_tpu_torch.checkpoint import _STATE_FILE
    from panacea_tpu_torch.config import load_perception_config
    from panacea_tpu_torch.parallel.mesh import rank_seed, shard_indices
    from panacea_tpu_torch.parallel.train import any_rank, barrier, broadcast_from_rank0
    from panacea_tpu_torch.perception.atss import fpn_shapes, grid_anchors
    from panacea_tpu_torch.perception.head import MemoryState, init_memory
    from panacea_tpu_torch.perception.train import (DetectorOptimizer, DetectorTrainer,
                                                    DetTrainState, cosine_schedule)
    from panacea_tpu_torch.perception.train_dataset import (PerceptionTrainDataset,
                                                            StreamingSampler)
    from panacea_tpu_torch.registry import instantiate_from_config

    device = group.device
    rank, world = group.rank, group.world
    # each rank's own draws (GridMask, DN, the dataset's augmentation), as
    # JAX folds the replica index into the step's key (train.py:427-432)
    seed = rank_seed(args.seed, rank)
    cfg = load_perception_config(args.config)["perception"]
    tcfg, ocfg, dcfg = cfg["train"], cfg["optimizer"], cfg["data"]
    det_cfg = dict(cfg["detector"])
    det_cfg["params"] = dict(det_cfg.get("params", {}), **(TINY if args.tiny else {}))
    if args.num_levels:
        det_cfg["params"]["num_levels"] = args.num_levels
    final_dim = (tuple(args.final_dim) if args.final_dim
                 else ((64, 128) if args.tiny else tuple(dcfg["ida"]["final_dim"])))
    if det_cfg["params"].get("backbone_type") == "eva":
        # EVA's position table sits at the images' token grid
        det_cfg["params"]["backbone_cfg"] = dict(det_cfg["params"].get("backbone_cfg") or {},
                                                 img_size=final_dim)
    model = instantiate_from_config(det_cfg).to(device)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))

    queue_length = int(args.queue_length or tcfg["queue_length"])
    seq_mode = bool(tcfg.get("seq_mode", False))
    seq_split_num = tcfg.get("seq_split_num", 2) if seq_mode else 0
    bs = args.batch if args.batch > 0 else (1 if args.tiny else int(tcfg.get("batch_size", 1)))
    filter_tokens = None
    if args.filter_file:
        import pickle

        with open(args.filter_file, "rb") as f:
            fd = pickle.load(f)
        fi = fd["infos"] if isinstance(fd, dict) else fd
        filter_tokens = [e["token"] if isinstance(e, dict) else e for e in fi]
    if args.synthetic:
        from panacea_tpu_torch.data.nuscenes.synthetic import make_synthetic_infos, path_seed

        infos = make_synthetic_infos(num_frames=max(queue_length, 2) * 4, num_boxes=6,
                                     seed=args.seed)
        for info in infos:
            info["ego2global_rotation"] = [1.0, 0.0, 0.0, 0.0]
            info["ego2global_translation"] = [2.0 * info["frame_idx"], 0, 0]
        loader = None
        if not args.gen_root:
            def loader(path):
                rs = np.random.RandomState(path_seed(path))
                return rs.uniform(0, 255, final_dim + (3,)).astype(np.float32)
        ds = PerceptionTrainDataset(
            infos=infos, queue_length=queue_length, final_dim=final_dim, image_loader=loader,
            gen_root=args.gen_root, gen_clip_len=args.gen_clip_len,
            filter_tokens=filter_tokens, random_length=int(tcfg.get("random_length", 0)),
            seq_split_num=seq_split_num, seed=seed)
    else:
        ds = PerceptionTrainDataset(
            ann_file=dcfg["ann_file"], gen_root=args.gen_root or dcfg.get("gen_root"),
            gen_clip_len=args.gen_clip_len, filter_tokens=filter_tokens,
            data_root=dcfg.get("data_root", "data/nuscenes/"), queue_length=queue_length,
            final_dim=final_dim, random_length=int(tcfg.get("random_length", 0)),
            ida_aug=dcfg.get("ida"),
            rot_range=tuple(dcfg["rot_range"]) if dcfg.get("rot_range") else None,
            scale_ratio_range=(tuple(dcfg["scale_ratio_range"])
                               if dcfg.get("scale_ratio_range") else None),
            seq_split_num=seq_split_num, seed=seed)

    if args.steps > 0:
        total_iters = args.steps
    else:
        per_epoch = int(tcfg["samples_per_epoch"]) // (int(tcfg["dp_devices"])
                                                       * int(tcfg["batch_size"]))
        total_iters = per_epoch * int(tcfg["num_epochs"])
    sch = ocfg.get("schedule", {})
    sched = cosine_schedule(base_lr=float(ocfg["lr"]),
                            warmup_iters=int(sch.get("warmup_iters", 500)),
                            warmup_ratio=float(sch.get("warmup_ratio", 1 / 3)),
                            total_iters=total_iters,
                            min_lr_ratio=float(sch.get("min_lr_ratio", 1e-3)))
    load_report = None
    if args.load_from or cfg.get("load_from"):
        load_report = load_init(model, args.load_from or cfg["load_from"])
    opt = DetectorOptimizer(
        dict(model.named_parameters()), weight_decay=float(ocfg["weight_decay"]),
        backbone_lr_mult=float(ocfg["backbone_lr_mult"]),
        grad_clip_norm=float(ocfg["grad_clip_norm"]), schedule=sched,
        backbone_frozen_stages=int(cfg.get("backbone_frozen_stages", -1)),
        backbone_bn_trainable=bool(cfg.get("backbone_bn_trainable", True)))
    nl = int(det_cfg["params"].get("num_levels", 5))
    # the ATSS anchors at the neck's strides: VoVNet's neck starts at 16
    anchors = grid_anchors(fpn_shapes(final_dim, nl, model.feat_strides[0]),
                           strides=model.feat_strides)
    pc_range = tuple(det_cfg["params"]["pc_range"])
    trainer = DetectorTrainer(
        pc_range, num_classes=int(det_cfg["params"].get("num_classes", 10)),
        cls_weight=float(tcfg["cls_weight"]), bbox_weight=float(tcfg["bbox_weight"]),
        use_grid_mask=bool(tcfg["use_grid_mask"]), with_dn=bool(tcfg["with_dn"]),
        dn_scalar=int(tcfg["dn_scalar"]), dn_noise_scale=float(tcfg["dn_noise_scale"]),
        dn_split=float(tcfg["dn_split"]), dn_weight=float(tcfg["dn_weight"]),
        anchors_per_level=anchors, num_frame_losses=int(tcfg["num_frame_losses"]),
        streaming=seq_mode)
    state = DetTrainState(model, opt)
    name = os.path.splitext(os.path.basename(args.config))[0]
    outdir = os.path.join(args.workdir, name)
    os.makedirs(outdir, exist_ok=True)
    n_trained = sum(p.numel() for p in state.params.values())
    print(f"device={device} trained parameters={n_trained} frozen tensors={len(opt.frozen)} "
          f"batch={bs} streaming={seq_mode}", flush=True)
    if world > 1 or os.environ.get("PANACEA_PERCEPTION_DP"):
        print(f"[ddp] rank {rank} of {world} process(es) x batch {bs} -> dp={world}, "
              f"backend {group.backend}, synced grads", flush=True)

    # this rank's training windows (the reference's DistributedGroupSampler,
    # JAX train_perception.py:343-346)
    valid_idx = shard_indices([i for i in range(len(ds)) if i >= queue_length - 1], rank, world)
    if not valid_idx:
        raise RuntimeError("the dataset has no full windows")
    eval_idx: list = []
    if args.eval_every > 0 and not seq_mode:
        # held out: the eval windows leave the training rotation
        k = min(args.eval_samples, max(len(valid_idx) - 1, 0))
        if k > 0:
            eval_idx, valid_idx = valid_idx[-k:], valid_idx[:-k]
    # the motion head's recipe: the ground truth's futures ride the windows
    # and feed the loss's trajectory term (JAX CLI :355-360)
    pred_steps = getattr(model.pts_bbox_head, "pred_steps", 0)
    sampler = memory = None
    if seq_mode:
        # held-out eval: whole sequence groups leave the sampler's pool
        held_groups: set = set()
        if args.eval_every > 0:
            flags = np.asarray(ds.seq_flags)
            groups_num = int(flags.max()) + 1
            g = groups_num - 1
            held_wins: list = []
            while (g >= 0 and groups_num - len(held_groups) - 1 >= bs * world
                   and len(held_wins) < args.eval_samples * world):
                held_groups.add(g)
                held_wins.extend(int(i) for i in np.where(flags == g)[0]
                                 if i >= queue_length - 1)
                g -= 1
            eval_idx = shard_indices(sorted(held_wins), rank, world)[:args.eval_samples]
        sampler = StreamingSampler(ds.seq_flags, batch_size=bs, num_replicas=world, rank=rank,
                                   seed=args.seed, exclude_groups=held_groups)
        memory = init_memory(bs, model.memory_len, model.embed_dims, device=device)

    generator = torch.Generator().manual_seed(seed)   # GridMask and DN draws, on the host
    step = ptr = draws = 0
    if args.resume:
        rpath = resume_path(args.resume)
        blob = torch.load(os.path.join(rpath, _STATE_FILE), map_location="cpu",
                          weights_only=False)
        model.load_state_dict(blob["model"], strict=True)
        opt.load_state_dict(blob["optimizer"])
        state.step = step = int(blob["step"])
        meta = blob["meta"]
        ranks = meta.get("ranks")
        if len(ranks or [meta]) != world:
            raise SystemExit(f"--resume {rpath}: written by {len(ranks or [meta])} rank(s), "
                             f"this run has {world}")
        if ranks:
            meta = ranks[rank]      # each rank's own cursor, draw states and memory
        ptr, draws = int(meta["ptr"]), int(meta["draws"])
        generator.set_state(meta["generator"])
        ds.rng.set_state(meta["ds_rng_state"])
        if sampler is not None:
            # the streams are deterministic: replaying the draws puts every
            # slot's stream and buffer back where they were
            for _ in range(draws):
                sampler.next_batch()
        if memory is not None and meta.get("memory") is not None:
            memory = MemoryState(*(m.to(device) for m in meta["memory"]))
        print(f"[resume] {rpath} -> step {step}", flush=True)
    # one set of parameters and statistics on every rank, as DDP starts
    broadcast_from_rank0(list(model.parameters()) + list(model.buffers()))

    t0 = time.time()
    metrics: Dict[str, float] = {}
    skipped = 0
    while step < total_iters:
        if sampler is not None:
            idxs = sampler.next_batch()
            draws += 1
            items = [ds.window_with_gt(i, max_gt=args.max_gt, pred_steps=pred_steps)
                     for i in idxs]
            if any_rank(any(it is None for it in items)):
                # a window without its history skips the draw: the streams
                # stay consumed, so the memory never meets another scene;
                # every rank skips with it, so the ranks stay in step (as the
                # JAX CLI all-gathers the miss flags, train_perception.py:472-489)
                skipped += 1
                if skipped > 2 * len(ds):
                    raise RuntimeError("the sampler's streams give no full training window")
                continue
            skipped = 0
        else:
            items, misses = [], 0
            while len(items) < bs and misses < 2 * len(valid_idx):
                it = ds.window_with_gt(valid_idx[ptr % len(valid_idx)], max_gt=args.max_gt,
                                       pred_steps=pred_steps)
                ptr += 1
                if it is None:
                    misses += 1
                else:
                    items.append(it)
            if len(items) < bs:
                raise RuntimeError("no full training windows in the dataset")
        imgs, data, *targets = collate(items, anchors, device)
        if seq_mode:
            # one frame a step: the window's axis of length 1 dropped
            out = trainer.step(state, imgs[:, 0], {k: v[:, 0] for k, v in data.items()},
                               *targets, generator=generator, memory=memory)
            memory = out.memory
        else:
            out = trainer.step(state, imgs, data, *targets, generator=generator)
        metrics = out.metrics
        step = state.step
        if rank == 0 and (step % 10 == 0 or step == total_iters):
            msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
            print(f"[{step}/{total_iters}] {msg} ({(time.time() - t0) / max(step, 1):.2f}s/it)",
                  flush=True)
        if args.ckpt_every > 0 and step % args.ckpt_every == 0:
            meta = {"ptr": ptr, "draws": draws, "generator": generator.get_state(),
                    "ds_rng_state": ds.rng.get_state(),
                    "memory": (None if memory is None
                               else MemoryState(*(m.cpu() for m in memory)))}
            if world > 1:
                every = [None] * world
                dist.all_gather_object(every, meta)
                meta = dict(meta, ranks=every)
            if rank == 0:
                save_checkpoint(outdir, state, meta)
            barrier()
        if args.eval_every > 0 and step % args.eval_every == 0:
            if rank == 0 and eval_idx:
                evaluate(model, ds, eval_idx, outdir, step, device)
            barrier()

    log: Dict[str, Any] = {"steps": step, "final_metrics": metrics}
    if rank != 0:
        barrier()
        return dict(log, state=state, outdir=outdir)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(outdir, "final.pt"))
    if load_report:
        log["load_from"] = load_report
    if args.gen_root or dcfg.get("gen_root"):
        # misses mean the reference's silent zero-image fallback fired
        log["gen_frames_loaded"] = int(ds.gen_hits)
        log["gen_frames_missing"] = int(ds.gen_misses)
        print(f"gen frames: {ds.gen_hits} loaded, {ds.gen_misses} missing", flush=True)
    with open(os.path.join(outdir, "train_log.json"), "w") as f:
        json.dump(log, f)
    print(f"done: {step} steps -> {outdir}", flush=True)
    barrier()
    return dict(log, state=state, outdir=outdir)


def evaluate(model, ds, eval_idx, outdir: str, step: int, device) -> Dict[str, float]:
    """The in-training eval hook (reference CustomDistEvalHook): the eval
    path's windows (``sliding_window``: fixed resize, no augmentation, no
    draw from the training RandomState), decoded and scored; one line of
    ``eval_log.jsonl``."""
    import torch

    from panacea_tpu_torch.perception.coder import NMSFreeCoder
    from panacea_tpu_torch.perception.metrics import CLASS_NAMES, evaluate_detections

    coder = NMSFreeCoder(pc_range=model.pc_range, max_num=min(300, model.num_query))
    preds, gts = [], []
    for ei in eval_idx:
        w = ds.sliding_window(ei)
        if w is None:
            continue
        w = {k: torch.as_tensor(v, device=device) for k, v in w.items()}
        imgs = w.pop("imgs")
        with torch.inference_mode():
            outs, _ = model(imgs, w)
        dets = coder.decode(outs)[0]
        preds.append({"boxes": dets["bboxes"], "labels": dets["labels"],
                      "scores": dets["scores"]})
        gts.append(ds.gt_for(ei, list(CLASS_NAMES)))
    if not preds:
        return {}
    res = evaluate_detections(preds, gts)
    print(f"[eval @{step}] NDS={res['NDS']:.4f} mAP={res['mAP']:.4f}", flush=True)
    with open(os.path.join(outdir, "eval_log.jsonl"), "a") as f:
        json.dump({"step": step, **{k: float(v) for k, v in res.items()}}, f)
        f.write("\n")
    return res
