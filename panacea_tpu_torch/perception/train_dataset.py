"""Training dataset for the StreamPETR recipes: sliding windows + GT.

The port's own copy of ``panacea_tpu/perception/train_dataset.py`` (NumPy
and cv2); its draws come from ``np.random.RandomState(seed)`` as there, so
windows, augmentations and ground truth equal the JAX dataset's array for
array, the motion head's future trajectories (``pred_steps > 0``) included.
Wraps GenNuScenesEvalDataset (same window/calibration machinery the eval
path uses) and adds the training annotations the reference's
CustomNuScenesDataset collects (nuscenes_dataset.py:439-449): per-key-frame
3D boxes/labels/velocity and per-camera 2D boxes/labels for the ATSS aux
head. Infos without 2D annotations (e.g. the synthetic generator) fall back
to projecting the 3D corners through lidar2img.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from panacea_tpu_torch.perception.eval_dataset import GenNuScenesEvalDataset
from panacea_tpu_torch.perception.metrics import CLASS_NAMES


def sequence_group_flags(scene_tokens: Sequence,
                         seq_split_num: int = 1) -> np.ndarray:
    """Per-index sequence-group id for streaming training
    (nuscenes_dataset.py:117-153 _set_sequence_group_flag): consecutive
    frames of one scene share a flag; each scene is then split into
    ``seq_split_num`` contiguous chunks of ceil(len/num) frames
    ('seq_split_num=2 # streaming video training', nopretrain.py:232) so
    memory resets mid-scene too. ``seq_split_num='all'`` makes every frame
    its own group."""
    res, cur = [], 0
    for i, tok in enumerate(scene_tokens):
        if i != 0 and tok != scene_tokens[i - 1]:
            cur += 1
        res.append(cur)
    flags = np.asarray(res, np.int64)
    if seq_split_num == 1:
        return flags
    if seq_split_num == "all":
        return np.arange(len(flags), dtype=np.int64)
    import math

    new_flags, cur_new = [], 0
    for n in np.bincount(flags):
        bounds = np.array(
            list(range(0, n, math.ceil(n / seq_split_num))) + [int(n)])
        for chunk in (bounds[1:] - bounds[:-1]):
            new_flags.extend([cur_new] * int(chunk))
            cur_new += 1
    assert len(new_flags) == len(flags)
    return np.asarray(new_flags, np.int64)


class StreamingSampler:
    """InfiniteGroupEachSampleInBatchSampler (group_sampler.py:154-236):
    every batch slot — across all replicas — consumes whole sequence groups
    back to back, in its own shuffled group order (so the recurrent memory
    sees scene-continuous frames), striding the global infinite group
    permutation stream by ``rank * batch_size + slot``. Shuffling is over
    group ORDER only; within-group frame order is preserved."""

    def __init__(self, flags: np.ndarray, batch_size: int = 1,
                 num_replicas: int = 1, rank: int = 0, seed: int = 0,
                 exclude_groups: Sequence[int] = ()):
        self.flags = np.asarray(flags)
        self.batch_size = batch_size
        self.groups_num = int(self.flags.max()) + 1
        self.global_batch_size = batch_size * num_replicas
        # exclude_groups: held-out sequence groups (e.g. the in-training
        # eval hook's windows) never enter any slot's stream
        self.group_pool = [g for g in range(self.groups_num)
                           if g not in set(exclude_groups)]
        assert len(self.group_pool) >= self.global_batch_size, (
            "need at least one non-held-out sequence group per global "
            "batch slot")
        self.group_idx_to_sample_idxs = {
            g: np.where(self.flags == g)[0].tolist()
            for g in range(self.groups_num)}
        self._streams = [
            self._strided_groups(rank * batch_size + s, seed)
            for s in range(batch_size)]
        self._buffers: List[List[int]] = [[] for _ in range(batch_size)]

    def _strided_groups(self, global_slot: int, seed: int):
        rs = np.random.RandomState(seed)
        pool = np.asarray(self.group_pool)
        pos = 0
        while True:
            for g in pool[rs.permutation(len(pool))].tolist():
                if pos % self.global_batch_size == global_slot:
                    yield g
                pos += 1

    def next_batch(self) -> List[int]:
        """Next sample index per slot (one optimizer step's batch)."""
        out = []
        for s in range(self.batch_size):
            if not self._buffers[s]:
                g = next(self._streams[s])
                self._buffers[s] = list(self.group_idx_to_sample_idxs[g])
            out.append(self._buffers[s].pop(0))
        return out

    def __iter__(self):
        while True:
            yield self.next_batch()


def corners_3d(boxes: np.ndarray) -> np.ndarray:
    """(G, >=7) (cx,cy,cz,w,l,h,yaw) -> (G, 8, 3) corners (devkit order-free)."""
    g = len(boxes)
    c = np.stack(np.meshgrid([-0.5, 0.5], [-0.5, 0.5], [-0.5, 0.5],
                             indexing="ij"), -1).reshape(8, 3)
    dims = boxes[:, 3:6]
    pts = c[None] * dims[:, None]                      # (G, 8, 3)
    yaw = boxes[:, 6]
    cos, sin = np.cos(yaw), np.sin(yaw)
    rot = np.zeros((g, 3, 3))
    rot[:, 0, 0], rot[:, 0, 1] = cos, -sin
    rot[:, 1, 0], rot[:, 1, 1] = sin, cos
    rot[:, 2, 2] = 1.0
    return np.einsum("gij,gkj->gki", rot, pts) + boxes[:, None, 0:3]


def project_boxes_2d(
    boxes3d: np.ndarray, labels: np.ndarray, lidar2img: np.ndarray,
    img_hw: Tuple[int, int], min_size: float = 4.0,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Project 3D boxes into each camera -> per-cam (Gi,4) xyxy + labels.
    Fallback for infos lacking the reference's precomputed bboxes2d."""
    h, w = img_hw
    out_b, out_l = [], []
    if len(boxes3d) == 0:
        for _ in range(len(lidar2img)):
            out_b.append(np.zeros((0, 4), np.float32))
            out_l.append(np.zeros((0,), np.int64))
        return out_b, out_l
    corners = corners_3d(boxes3d)                       # (G, 8, 3)
    hom = np.concatenate([corners, np.ones_like(corners[..., :1])], -1)
    for l2i in lidar2img:
        cam = hom @ l2i.T                               # (G, 8, 4)
        z = cam[..., 2]
        front = z > 0.05
        uv = cam[..., :2] / np.maximum(z[..., None], 0.05)
        boxes2d, lbls = [], []
        for gi in range(len(boxes3d)):
            if front[gi].sum() < 2:
                continue
            u, v = uv[gi, front[gi], 0], uv[gi, front[gi], 1]
            x0, x1 = np.clip(u.min(), 0, w), np.clip(u.max(), 0, w)
            y0, y1 = np.clip(v.min(), 0, h), np.clip(v.max(), 0, h)
            if x1 - x0 < min_size or y1 - y0 < min_size:
                continue
            boxes2d.append([x0, y0, x1, y1])
            lbls.append(labels[gi])
        out_b.append(np.asarray(boxes2d, np.float32).reshape(-1, 4))
        out_l.append(np.asarray(lbls, np.int64))
    return out_b, out_l


class PerceptionTrainDataset(GenNuScenesEvalDataset):
    """Sliding windows with GT for detector training.

    ``window_with_gt(i, max_gt)`` returns the eval window dict plus
    gt_boxes (1, max_gt, 9) zero-padded, gt_labels (1, max_gt) -1-padded,
    and per-camera 2D GT lists for the last frame.

    Training-recipe knobs (reference config window.py:188-196, :235):
    ``random_length`` jitters the sliding-window history (prepare_train_data,
    nuscenes_dataset.py:163-167: reach random_length further back, drop a
    random subset); ``ida_aug`` = {resize_lim, rand_flip} samples one IDA
    resize/flip per window (applied consistently across cams and frames, with
    matching lidar2img and 2D-GT updates); ``rot_range``/``scale_ratio_range``
    enable GlobalRotScaleTransImage on the 3D GT + projections."""

    def __init__(self, *args, random_length: int = 0,
                 ida_aug: Optional[Dict] = None,
                 rot_range: Optional[Tuple[float, float]] = None,
                 scale_ratio_range: Optional[Tuple[float, float]] = None,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0,
                                              51.2, 51.2, 3.0),
                 seq_split_num: int = 0,
                 seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.pc_range = tuple(pc_range)
        self.random_length = int(random_length)
        self.ida_aug = ida_aug
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range
        # seq_mode (nopretrain.py:233): the window's FIRST frame keeps its
        # memory when the previous dataset index is in the same seq-split
        # group (nuscenes_dataset.py:424) — streaming recurrence across
        # optimizer steps. 0 = sliding-window mode (always reset).
        self.seq_flags = (sequence_group_flags(self.scene_tokens,
                                               seq_split_num)
                          if seq_split_num else None)
        self.rng = np.random.RandomState(seed)

    def _sample_ida(self) -> Tuple[Optional[float], bool]:
        if not self.ida_aug:
            return None, False
        lo, hi = self.ida_aug.get("resize_lim",
                                  (self.resize_factor, self.resize_factor))
        resize = float(self.rng.uniform(lo, hi))
        flip = (bool(self.rng.rand() < 0.5)
                if self.ida_aug.get("rand_flip") else False)
        return resize, flip

    def train_window(self, key_idx: int):
        """Jittered training window (nuscenes_dataset.py:155-178): candidate
        history of queue_length+random_length-1 indices, drop random_length
        at random, clamp to 0, per-frame prev_exists on scene change.
        Returns (window dict, aug dict) or None."""
        ql, rl = self.queue_length, self.random_length
        cand = list(range(key_idx - ql - rl + 1, key_idx))
        if rl:
            self.rng.shuffle(cand)
            cand = sorted(cand[rl:])
        idxs = [max(0, i) for i in cand] + [key_idx]
        if ql > 1 and key_idx - ql - rl + 1 < 0 and not any(
                self.scene_tokens[i] == self.scene_tokens[key_idx]
                for i in idxs[:-1]):
            return None
        # training on a GENERATED tree (the pseudo-pretrain recipe,
        # pseudo_pretrain.py:234 data_root -> gen-nuscenes): same disjoint-
        # clip contract as sliding_window — clips cover [key-cl+1, key] at
        # offsets [0, cl), keyed by the clip-END frame's stem, so only
        # clip-end keys yield fully-generated windows (history jitter is
        # incompatible: dropped candidates break the offset<->sample pairing)
        offset0 = 0
        if (self.gen_root is not None and self.image_loader is None
                and self.gen_clip_len):
            cl = self.gen_clip_len
            if ql > cl or rl:
                return None
            scene = self.scene_tokens[key_idx]
            start = key_idx
            while start > 0 and self.scene_tokens[start - 1] == scene:
                start -= 1
            if (key_idx - start + 1) % cl != 0:
                return None
            offset0 = cl - ql
        resize, flip = self._sample_ida()
        frames = [
            self.frame_inputs(i, key_idx, frame_offset=offset0 + fi,
                              resize_factor=resize, flip=flip)
            for fi, i in enumerate(idxs)
        ]
        t = len(frames)
        prev = np.zeros(t, dtype=np.float32)
        for k in range(1, t):
            prev[k] = float(self.scene_tokens[idxs[k]]
                            == self.scene_tokens[idxs[k - 1]])
        if self.seq_flags is not None:
            # streaming continuity with the PREVIOUS dataset index
            # (nuscenes_dataset.py:424: prev_exists = not (index == 0 or
            # flag[index-1] != flag[index]))
            i0 = idxs[0]
            prev[0] = float(i0 != 0
                            and self.seq_flags[i0 - 1] == self.seq_flags[i0])
        out = {
            "imgs": np.stack([f["imgs"] for f in frames])[None],
            "prev_exists": prev[None],
            "timestamp": np.stack([f["timestamp"] for f in frames])[None],
        }
        for k in ("lidar2img", "intrinsics", "extrinsics", "ego_pose",
                  "ego_pose_inv"):
            out[k] = np.stack([f[k] for f in frames])[None]
        return out, {"resize": resize or self.resize_factor, "flip": flip}

    def window_with_gt(self, key_idx: int, max_gt: int = 64,
                       class_names: Optional[Sequence[str]] = None,
                       pred_steps: int = 0):
        """``pred_steps > 0`` (the motion head's recipe) also returns the
        ground truth's future trajectories, gt_trajs (1, max_gt, S, 2) and
        gt_traj_mask (1, max_gt, S, 2) (data/nuscenes/trajectory.py), their
        rows aligned with the filtered boxes through gt_for's ``keep`` and
        rotated by the global rot/scale augmentation that moves the boxes."""
        item = self.train_window(key_idx)
        if item is None:
            return None
        window, aug = item
        names = list(class_names or CLASS_NAMES)
        # training recipe: valid_flag mask + ObjectRangeFilter
        # (window.py:201, :242); eval GT (gt_for defaults) stays unfiltered
        gt = self.gt_for(key_idx, names, use_valid_flag=True,
                         bev_range=self.pc_range)
        boxes, labels = gt["boxes"], gt["labels"]
        g = min(len(labels), max_gt)
        gt_trajs = gt_traj_mask = None
        if pred_steps > 0:
            from panacea_tpu_torch.data.nuscenes.trajectory import future_trajectories

            fut, fmask = future_trajectories(self.infos, key_idx, pred_steps=pred_steps)
            gt_trajs = np.zeros((1, max_gt, pred_steps, 2), np.float32)
            gt_traj_mask = np.zeros((1, max_gt, pred_steps, 2), np.float32)
            keep = gt["keep"][:g]
            gt_trajs[0, :g] = fut[keep]
            gt_traj_mask[0, :g] = fmask[keep]
        gt_boxes = np.zeros((1, max_gt, 9), np.float32)
        gt_labels = np.full((1, max_gt), -1, np.int64)
        if g:
            b9 = np.asarray(boxes[:g], np.float32)
            if b9.shape[1] < 9:
                b9 = np.concatenate(
                    [b9, np.zeros((g, 9 - b9.shape[1]), np.float32)], 1)
            gt_boxes[0, :g] = b9[:, :9]
            gt_labels[0, :g] = labels[:g]

        if self.rot_range is not None or self.scale_ratio_range is not None:
            from panacea_tpu_torch.data.nuscenes.augment import global_rot_scale_trans

            l2i_all = window["lidar2img"].reshape(-1, 4, 4)
            aug_boxes, l2i_all, inv = global_rot_scale_trans(
                gt_boxes[0, :g], l2i_all, self.rng,
                rot_range=self.rot_range or (0.0, 0.0),
                scale_range=self.scale_ratio_range or (1.0, 1.0),
            )
            gt_boxes[0, :g] = aug_boxes
            if gt_trajs is not None and g:
                # the futures turn with the boxes: the forward rotation
                gt_trajs[0, :g] = np.einsum("ij,gsj->gsi", np.linalg.inv(inv)[:2, :2],
                                            gt_trajs[0, :g])
            window["lidar2img"] = l2i_all.reshape(
                window["lidar2img"].shape).astype(np.float32)
            # the reference folds the same inverse transform into every pose
            # matrix (transform_3d.py:619-624, 638-644) so ego-motion memory
            # alignment and the extrinsics-built PE stay in the augmented frame
            fwd = np.linalg.inv(inv)
            for k in ("extrinsics", "ego_pose"):
                if k in window:
                    m = window[k].reshape(-1, 4, 4) @ inv
                    window[k] = m.reshape(window[k].shape).astype(np.float32)
            if "ego_pose_inv" in window:
                m = fwd @ window["ego_pose_inv"].reshape(-1, 4, 4)
                window["ego_pose_inv"] = m.reshape(
                    window["ego_pose_inv"].shape).astype(np.float32)

        info = self.infos[key_idx]
        if "bboxes2d" in info:
            # reference 2D annotations (nuscenes2d infos, per camera)
            gt2d_boxes = [np.asarray(b, np.float32).reshape(-1, 4)
                          for b in info["bboxes2d"]]
            gt2d_labels = [np.asarray(l, np.int64)
                           for l in info["labels2d"]]
            # 2D annos are in ORIGINAL pixels; rescale to final_dim via the
            # same resize/crop the images got
            from panacea_tpu_torch.data.nuscenes.calib import standard_ida_resize_crop

            resize, crop = standard_ida_resize_crop(
                self.src_hw, aug["resize"], self.final_dim)
            f_h, f_w = self.final_dim
            # reference _bboxes_transform (transform_3d.py:399-433): scale,
            # crop, CLIP to final_dim, drop boxes under min_size=2, flip as
            # fW - x. (The depth-ordered _filter_invisible occlusion pass
            # :436-460 needs per-box depths the infos don't carry; boxes
            # fully hidden behind nearer ones are kept — a slightly larger
            # positive set, not wrong geometry.)
            min_size = 2.0
            scaled_b, scaled_l = [], []
            for b, l in zip(gt2d_boxes, gt2d_labels):
                b = b * resize
                b[:, [0, 2]] = np.clip(b[:, [0, 2]] - crop[0], 0, f_w)
                b[:, [1, 3]] = np.clip(b[:, [1, 3]] - crop[1], 0, f_h)
                keep = ((b[:, 2] - b[:, 0]) >= min_size) \
                    & ((b[:, 3] - b[:, 1]) >= min_size)
                if aug["flip"]:
                    b[:, [0, 2]] = f_w - b[:, [2, 0]]
                scaled_b.append(b[keep])
                scaled_l.append(l[keep])
            gt2d_boxes, gt2d_labels = scaled_b, scaled_l
        else:
            l2i = window["lidar2img"][0, -1]            # last frame (N,4,4)
            gt2d_boxes, gt2d_labels = project_boxes_2d(
                gt_boxes[0, :g], gt_labels[0, :g], l2i, self.final_dim)
        if pred_steps > 0:
            return (window, gt_boxes, gt_labels, gt2d_boxes, gt2d_labels, gt_trajs,
                    gt_traj_mask)
        return window, gt_boxes, gt_labels, gt2d_boxes, gt2d_labels
