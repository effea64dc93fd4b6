"""Training-time 3D augmentations for the detector data path.

The port's own copy of ``panacea_tpu/data/nuscenes/augment.py`` (NumPy).
Equivalent of the reference's GlobalRotScaleTransImage (train pipeline,
streampetr_r50_atss_512x256_window.py:135-141): rotate/scale the 3D scene
around the ego z-axis and update every camera's lidar2img accordingly
(reverse_angle convention), plus the random horizontal image flip of
ResizeCropFlipRotImage with its intrinsic update.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from panacea_tpu_torch.data.nuscenes.calib import yaw_to_rotmat


def global_rot_scale_trans(
    gt_boxes: np.ndarray,
    lidar2imgs: np.ndarray,
    rng: np.random.RandomState,
    rot_range: Tuple[float, float] = (-0.3925, 0.3925),
    scale_range: Tuple[float, float] = (0.95, 1.05),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rotate + scale boxes in the ego frame; fold the inverse transform into
    lidar2img so projections stay consistent. Returns (boxes, lidar2imgs,
    inv) where `inv` is the 4x4 inverse scene transform that must ALSO be
    right-multiplied into extrinsics/ego_pose (and its inverse left-multiplied
    into ego_pose_inv) exactly as the reference does for every pose matrix it
    carries (transform_3d.py:619-624, 638-644) — otherwise temporal memory
    alignment runs in the un-augmented frame."""
    angle = rng.uniform(*rot_range)
    scale = rng.uniform(*scale_range)

    rot = yaw_to_rotmat(angle)
    boxes = gt_boxes.copy()
    if len(boxes):
        boxes[:, :3] = boxes[:, :3] @ rot.T
        # centers/velocities above rotate by +angle, so yaw must too. (The
        # reference's reverse_angle=True flag only reconciles its two
        # mutually-reversed matrix conventions — _rotate_bev_along_z rot_mat
        # vs mmdet3d Box.rotate — its NET effect is centers AND yaw rotating
        # by the same angle, transform_3d.py:583-588.)
        boxes[:, 6] += angle
        boxes[:, :6] *= scale
        if boxes.shape[1] > 7:
            boxes[:, 7:9] = boxes[:, 7:9] @ rot[:2, :2].T * scale

    # cameras see the ORIGINAL scene; points were moved by R*s, so project
    # through lidar2img @ (R*s)^-1
    inv = np.eye(4)
    inv[:3, :3] = rot.T / scale
    l2i = np.asarray([m @ inv for m in lidar2imgs])
    return boxes, l2i, inv


def horizontal_flip_image(
    img: np.ndarray, lidar2img: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Flip one camera image and update its projection (the u coordinate maps
    to W-1-u: post-matrix [[-1,0,W-1],[0,1,0],[0,0,1]])."""
    h, w = img.shape[:2]
    flipped = img[:, ::-1].copy()
    post = np.eye(4)
    post[0, 0] = -1.0
    post[0, 2] = w - 1.0  # multiplies z: u'*z = -u*z + (w-1)*z
    return flipped, post @ lidar2img
