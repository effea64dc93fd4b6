"""Camera calibration math (pure NumPy).

Replaces pyquaternion + the mmdet3d plugin's pose assembly
(projects/mmdet3d_plugin/datasets/nuscenes_dataset.py:205-246):
lidar2img = viewpad @ inverse(cam2ego) with quaternion extrinsics, plus the
intrinsic update applied by ResizeCropFlipRotImage
(transform_3d.py:114-180) when images are resized/cropped.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def quat_to_rotmat(q: Sequence[float]) -> np.ndarray:
    """Quaternion (w, x, y, z) -> 3x3 rotation matrix (nuScenes convention)."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def yaw_to_rotmat(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def pose_to_matrix(rotation: np.ndarray, translation: Sequence[float]) -> np.ndarray:
    """(R, t) -> 4x4 homogeneous matrix (convert_egopose_to_matrix_numpy)."""
    m = np.eye(4)
    m[:3, :3] = rotation
    m[:3, 3] = np.asarray(translation, dtype=np.float64)
    return m


def invert_pose(m: np.ndarray) -> np.ndarray:
    """Rigid-transform inverse (invert_matrix_egopose_numpy)."""
    out = np.eye(4)
    r = m[:3, :3]
    t = m[:3, 3]
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ t
    return out


def build_lidar2img(
    sensor2ego_rotation: Sequence[float],
    sensor2ego_translation: Sequence[float],
    cam_intrinsic: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (lidar2img, viewpad, lidar2cam), all 4x4
    (nuscenes_dataset.py:231-246)."""
    cam2lidar = pose_to_matrix(
        quat_to_rotmat(sensor2ego_rotation), sensor2ego_translation
    )
    lidar2cam = invert_pose(cam2lidar)
    viewpad = np.eye(4)
    intr = np.asarray(cam_intrinsic)
    viewpad[: intr.shape[0], : intr.shape[1]] = intr
    return viewpad @ lidar2cam, viewpad, lidar2cam


def update_intrinsics_resize_crop(
    lidar2img: np.ndarray,
    viewpad: np.ndarray,
    resize: float,
    crop: Tuple[int, int, int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply the resize+crop image augmentation to the projection matrices
    (ResizeCropFlipRotImage semantics, transform_3d.py:142-180): scale focal/
    principal by ``resize`` then shift by the crop's top-left corner.
    crop = (x0, y0, x1, y1).

    NOTE the pixel shift multiplies the z (depth) column of the projective
    matrix — homogeneous pixel coords are (u*z, v*z, z, 1), so
    u' = u*r - x0 requires post[0, 2] = -x0, NOT post[0, 3]."""
    post = np.eye(4)
    post[0, 0] = resize
    post[1, 1] = resize
    post[0, 2] = -crop[0]
    post[1, 2] = -crop[1]
    return post @ lidar2img, post @ viewpad


def standard_ida_resize_crop(
    src_hw: Tuple[int, int] = (900, 1600),
    resize: float = 0.32,
    final_dim: Tuple[int, int] = (256, 512),
    bot_pct: float = 0.0,
) -> Tuple[float, Tuple[int, int, int, int]]:
    """The production ida_aug_conf (nuscenes_datasets_video.py:149-157):
    resize 0.32, final 256x512, crop anchored at the bottom."""
    h, w = src_hw
    fh, fw = final_dim
    new_w, new_h = int(w * resize), int(h * resize)
    crop_h = int((1 - bot_pct) * new_h) - fh
    crop_w = max(0, int(max(0, new_w - fw) / 2))
    crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
    return resize, crop
