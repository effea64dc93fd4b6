"""Gen-nuScenes evaluation dataset.

The port's own copy of ``panacea_tpu/perception/eval_dataset.py`` (NumPy and
cv2), on the port's ``data/nuscenes`` modules. Equivalent of
metrics/.../datasets/nuscenes_dataset.py:32-345: sliding 8-frame test queues
where real camera JPEGs are replaced by generated frames from a Gen-nuScenes
root (``<root>/<CAM>_<file-stem>/_00000<i>.jpg``, :222, :316-345),
with zero-image fallback for missing files (:330-345) and optional token
filtering (:101-112). Produces the detector's input dict (normalized images +
calib/pose tensors).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from panacea_tpu_torch.data.nuscenes.augment import horizontal_flip_image
from panacea_tpu_torch.data.nuscenes.calib import (
    build_lidar2img,
    pose_to_matrix,
    quat_to_rotmat,
    invert_pose,
    standard_ida_resize_crop,
    update_intrinsics_resize_crop,
)
from panacea_tpu_torch.data.nuscenes.dataset import CAM_ORDER, load_infos
from panacea_tpu_torch.perception.detector import IMG_MEAN, IMG_STD


class GenNuScenesEvalDataset:
    def __init__(
        self,
        ann_file: Optional[str] = None,
        infos: Optional[List[Dict]] = None,
        gen_root: Optional[str] = None,
        data_root: str = "data/nuscenes/",
        queue_length: int = 8,
        final_dim=(256, 512),
        resize: float = 0.32,
        src_hw=(900, 1600),
        filter_tokens: Optional[Sequence[str]] = None,
        image_loader=None,
        gen_clip_len: Optional[int] = None,
    ):
        self.infos = infos if infos is not None else load_infos(ann_file)
        if filter_tokens is not None:
            keep = set(filter_tokens)
            self.infos = [i for i in self.infos if i["token"] in keep]
        self.gen_root = gen_root
        self.data_root = data_root
        self.queue_length = queue_length
        self.final_dim = final_dim
        self.resize_factor = resize
        self.src_hw = src_hw
        self.scene_tokens = [i.get("scene_token") for i in self.infos]
        self.image_loader = image_loader
        # generation runs that wrote DISJOINT clips (one per gen_clip_len
        # samples, dir keyed by each clip's LAST frame) instead of the
        # reference's one-trailing-clip-per-sample layout: evaluate only at
        # clip-end key frames and offset window frames into the clip, so every
        # history image is paired with the calib/ego-pose of the SAME real
        # sample it was generated for
        self.gen_clip_len = gen_clip_len
        # layout-contract accounting: how many generated frames were found
        # vs zero-filled (the reference's silent fallback, :330-345, would
        # otherwise hide a writer/reader dir-naming drift)
        self.gen_hits = 0
        self.gen_misses = 0

    def __len__(self):
        return len(self.infos)

    def _load_generated(self, cam_path: str, frame_offset: int):
        """Load a generated frame for the clip keyed by ``cam_path``'s stem;
        zero image on miss (reference fallback, nuscenes_dataset.py:330-345).
        Generated frames are already at final_dim."""
        import cv2

        stem = os.path.basename(cam_path).rsplit(".", 1)[0]
        parts = stem.split("__")
        cam = parts[-2] if len(parts) >= 2 else "CAM"
        path = os.path.join(self.gen_root, f"{cam}_{stem}",
                            f"_{frame_offset:06d}.jpg")
        img = cv2.imread(path)
        if img is None:
            self.gen_misses += 1
            return np.zeros(self.final_dim + (3,), dtype=np.float32)
        self.gen_hits += 1
        return img[:, :, ::-1].astype(np.float32)

    def _load_real(self, cam_path: str, resize_factor: Optional[float] = None):
        import cv2

        p = cam_path
        if not os.path.isabs(p) and not os.path.exists(p):
            p = os.path.join(self.data_root, cam_path)
        img = cv2.imread(p)
        if img is None:
            img = np.zeros(self.src_hw + (3,), dtype=np.uint8)
        img = img[:, :, ::-1]
        resize, crop = standard_ida_resize_crop(
            self.src_hw, resize_factor or self.resize_factor, self.final_dim
        )
        nh, nw = int(img.shape[0] * resize), int(img.shape[1] * resize)
        img = cv2.resize(img, (nw, nh))
        x0, y0, x1, y1 = crop
        return img[y0:y1, x0:x1].astype(np.float32)

    def frame_inputs(self, idx: int, key_idx: int,
                     frame_offset: Optional[int] = None,
                     resize_factor: Optional[float] = None,
                     flip: bool = False) -> Dict[str, Any]:
        """Inputs for frame ``idx``; generated images are indexed by the
        key-frame clip (the last frame's stem names the directory).
        ``resize_factor``/``flip`` override the dataset defaults for IDA
        training augmentation (ResizeCropFlipRotImage, transform_3d.py)."""
        info = self.infos[idx]
        key_info = self.infos[key_idx]
        resize, crop = standard_ida_resize_crop(
            self.src_hw, resize_factor or self.resize_factor, self.final_dim
        )
        imgs, l2is, intrs, extrs = [], [], [], []
        for cam in CAM_ORDER:
            cinfo = info["cams"][cam]
            if self.image_loader is not None:
                img = self.image_loader(cinfo["data_path"])
            elif self.gen_root is not None and frame_offset is not None:
                img = self._load_generated(
                    key_info["cams"][cam]["data_path"], frame_offset
                )
            else:
                img = self._load_real(cinfo["data_path"], resize_factor)
            l2i, viewpad, l2c = build_lidar2img(
                cinfo["sensor2ego_rotation"],
                cinfo["sensor2ego_translation"],
                np.asarray(cinfo["cam_intrinsic"]),
            )
            l2i, viewpad = update_intrinsics_resize_crop(
                l2i, viewpad, resize, crop
            )
            if flip:
                img, l2i = horizontal_flip_image(img, l2i)
                post = np.eye(4)
                post[0, 0], post[0, 2] = -1.0, img.shape[1] - 1.0
                viewpad = post @ viewpad
            imgs.append((img - np.asarray(IMG_MEAN)) / np.asarray(IMG_STD))
            l2is.append(l2i)
            intrs.append(viewpad)
            extrs.append(l2c)
        e2g = pose_to_matrix(
            quat_to_rotmat(info["ego2global_rotation"]),
            info["ego2global_translation"],
        ) if "ego2global_rotation" in info else np.eye(4)
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "lidar2img": np.stack(l2is).astype(np.float32),
            "intrinsics": np.stack(intrs).astype(np.float32),
            "extrinsics": np.stack(extrs).astype(np.float32),
            "ego_pose": e2g.astype(np.float32),
            "ego_pose_inv": invert_pose(e2g).astype(np.float32),
            "timestamp": np.float32(info["timestamp"] / 1e6),
        }

    def sliding_window(self, key_idx: int) -> Optional[Dict[str, np.ndarray]]:
        """8-frame window ending at key_idx (prepare_sliding_test_data,
        nuscenes_dataset.py:260-289). Returns batched (1, T, ...) arrays."""
        lo = key_idx - self.queue_length + 1
        if lo < 0:
            return None
        scene = self.scene_tokens[key_idx]
        idxs = list(range(lo, key_idx + 1))
        if any(self.scene_tokens[i] != scene for i in idxs):
            return None
        offset0 = 0
        if self.gen_clip_len:
            cl = self.gen_clip_len
            if self.queue_length > cl:
                return None
            start = key_idx
            while start > 0 and self.scene_tokens[start - 1] == scene:
                start -= 1
            # clips cover [key-cl+1, key] at offsets [0, cl); only keys where
            # a generated clip actually ends are evaluable
            if (key_idx - start + 1) % cl != 0:
                return None
            offset0 = cl - self.queue_length
        frames = [
            self.frame_inputs(i, key_idx, frame_offset=offset0 + fi)
            for fi, i in enumerate(idxs)
        ]
        t = len(frames)
        prev = np.ones(t, dtype=np.float32)
        prev[0] = 0.0  # window start resets memory
        out = {
            "imgs": np.stack([f["imgs"] for f in frames])[None],
            "prev_exists": prev[None],
            "timestamp": np.stack([f["timestamp"] for f in frames])[None],
        }
        for k in ("lidar2img", "intrinsics", "extrinsics", "ego_pose",
                  "ego_pose_inv"):
            out[k] = np.stack([f[k] for f in frames])[None]
        return out

    def gt_for(self, key_idx: int, class_names: Sequence[str],
               use_valid_flag: bool = False,
               bev_range: Optional[Sequence[float]] = None) -> Dict:
        """GT boxes/labels for one key frame (ObjectNameFilter semantics).

        Training adds the reference recipe's two extra filters
        (window.py:201,242): ``use_valid_flag`` drops zero-lidar/radar-point
        annotations (mmdet3d get_ann_info with use_valid_flag=True) and
        ``bev_range`` = pc_range applies ObjectRangeFilter (keep boxes whose
        BEV center lies inside [x_min,y_min,x_max,y_max]); a gt outside the
        sigmoid-bounded pc range could otherwise never be reconstructed yet
        would consume a Hungarian match."""
        info = self.infos[key_idx]
        boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))))
        names = list(info.get("gt_names", []))
        vel = np.asarray(info.get("gt_velocity",
                                  np.zeros((len(boxes), 2))))
        labels = np.array(
            [class_names.index(n) if n in class_names else -1 for n in names]
        )
        mask = labels >= 0
        if use_valid_flag and "valid_flag" in info:
            mask &= np.asarray(info["valid_flag"], bool)
        if bev_range is not None and len(boxes):
            r = np.asarray(bev_range, np.float32)
            if len(r) == 6:  # pc_range -> bev [x0, y0, x1, y1]
                r = r[[0, 1, 3, 4]]
            mask &= ((boxes[:, 0] > r[0]) & (boxes[:, 1] > r[1])
                     & (boxes[:, 0] < r[2]) & (boxes[:, 1] < r[3]))
        if boxes.shape[1] == 7:
            boxes = np.concatenate([boxes, np.nan_to_num(vel)], axis=1)
        # 'keep': original info-row indices of the surviving boxes, so
        # callers can align per-box side data (e.g. GT future trajectories)
        return {"boxes": boxes[mask], "labels": labels[mask],
                "keep": np.nonzero(mask)[0]}
