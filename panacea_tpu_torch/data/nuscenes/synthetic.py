"""Synthetic nuScenes-style scenes for tests and demos.

Generates info dicts in the same schema as the mmdet3d info pkls (6 cameras at
60-degree yaw spacing, pinhole intrinsics at 1600x900, moving boxes, straight
lane polylines), so the full data pipeline runs without the real dataset.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List

import numpy as np

from panacea_tpu_torch.data.nuscenes.dataset import CAT2ID_MAP

CAT_PED = CAT2ID_MAP["ped_crossing"]
CAT_DIVIDER = CAT2ID_MAP["divider"]
CAT_BOUNDARY = CAT2ID_MAP["boundary"]


def _yaw_quat(yaw: float):
    """(w, x, y, z) for rotation about +z."""
    return [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]


def _cam_quat(yaw: float):
    """Camera mounted looking outward at ego-yaw ``yaw``: camera +z (optical
    axis) points along the ego direction (cos yaw, sin yaw, 0), +x right,
    +y down. Returns (w,x,y,z) of the cam->ego rotation."""
    # columns of R = images of camera basis vectors in ego frame
    fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])   # optical axis
    right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
    down = np.array([0.0, 0.0, -1.0])
    r = np.stack([right, down, fwd], axis=1)
    # rotation matrix -> quaternion
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (r[2, 1] - r[1, 2]) / s
        y = (r[0, 2] - r[2, 0]) / s
        z = (r[1, 0] - r[0, 1]) / s
    else:
        i = np.argmax(np.diag(r))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(r[i, i] - r[j, j] - r[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i + 1] = 0.25 * s
        q[0] = (r[k, j] - r[j, k]) / s
        q[j + 1] = (r[j, i] + r[i, j]) / s
        q[k + 1] = (r[k, i] + r[i, k]) / s
        w, x, y, z = q
    return [float(w), float(x), float(y), float(z)]


CAM_YAWS = {
    "CAM_FRONT": 0.0,
    "CAM_FRONT_RIGHT": -np.pi / 3,
    "CAM_FRONT_LEFT": np.pi / 3,
    "CAM_BACK": np.pi,
    "CAM_BACK_LEFT": 2 * np.pi / 3,
    "CAM_BACK_RIGHT": -2 * np.pi / 3,
}


def make_synthetic_infos(
    num_frames: int = 8,
    num_boxes: int = 5,
    seed: int = 0,
    scene_token: str = "synthetic-scene-0",
) -> List[Dict[str, Any]]:
    rng = np.random.RandomState(seed)
    intrinsic = np.array(
        [[800.0, 0.0, 800.0], [0.0, 800.0, 450.0], [0.0, 0.0, 1.0]]
    )
    # static boxes relative to a moving ego
    base_xy = rng.uniform(-25, 25, (num_boxes, 2))
    dims = np.abs(rng.normal([4.5, 1.9, 1.6], 0.3, (num_boxes, 3)))
    yaws = rng.uniform(-np.pi, np.pi, num_boxes)
    names = rng.choice(["car", "truck", "bus", "pedestrian"], num_boxes)

    infos = []
    for t in range(num_frames):
        ego_x = 2.0 * t  # ego moves forward 2 m/frame
        cams = {}
        for cam, yaw in CAM_YAWS.items():
            # nuScenes-style stem (scene__CAM__timestamp) so the stem->cam
            # parse (stem.split('__')[-2]) behaves exactly as on real data —
            # both the Gen-nuScenes writer (writers.py:59) and the eval
            # reader (perception/eval_dataset.py:_load_generated) key dirs
            # off this
            cams[cam] = {
                "data_path": f"synthetic/{cam}/synth__{cam}__{t:012d}.jpg",
                "timestamp": 1_000_000 * t,
                "sensor2ego_rotation": _cam_quat(yaw),
                "sensor2ego_translation": [
                    1.5 * np.cos(yaw), 1.5 * np.sin(yaw), 1.6
                ],
                "cam_intrinsic": intrinsic.copy(),
            }
        boxes = np.zeros((num_boxes, 7))
        boxes[:, 0] = base_xy[:, 0] - ego_x
        boxes[:, 1] = base_xy[:, 1]
        boxes[:, 2] = -1.5
        boxes[:, 3:6] = dims
        boxes[:, 6] = yaws
        # straight road: two boundaries and one divider along ego x
        vectors = {
            CAT_DIVIDER: [np.array([[-30.0 - ego_x % 2, 0.0],
                                    [30.0, 0.0]])],
            CAT_BOUNDARY: [
                np.array([[-30.0, -7.0], [30.0, -7.0]]),
                np.array([[-30.0, 7.0], [30.0, 7.0]]),
            ],
            CAT_PED: [np.array([[5.0, -7.0], [5.0, 7.0]])],
        }
        infos.append({
            "token": f"synth-{t:04d}",
            "scene_token": scene_token,
            "timestamp": 1_000_000 * t,
            "frame_idx": t,
            "cams": cams,
            "gt_boxes": boxes,
            "gt_names": list(names),
            "valid_flag": np.ones(num_boxes, dtype=bool),
            # stable per-instance ids (boxes persist across frames) for
            # tracking/trajectory supervision (data/nuscenes/trajectory.py)
            "instance_inds": np.arange(num_boxes, dtype=np.int64),
            "map_vectors": vectors,
        })
    return infos


def path_seed(path: str) -> int:
    """Process-stable PRNG seed from a path. Python's ``hash()`` is salted
    per interpreter (PYTHONHASHSEED), so it would give every process a
    different synthetic dataset — breaking cross-process reproducibility
    and the exact-resume contract (tests/test_checkpoint_resume.py)."""
    return zlib.crc32(path.encode("utf-8")) & 0x7FFFFFFF


def synthetic_image_loader(path: str) -> np.ndarray:
    """Deterministic gradient image per path (no disk IO)."""
    h, w = 900, 1600
    rng = np.random.RandomState(path_seed(path))
    base = rng.randint(0, 255, (3,))
    yy = np.linspace(0, 1, h)[:, None, None]
    xx = np.linspace(0, 1, w)[None, :, None]
    img = (base * (0.5 + 0.5 * yy * xx)).astype(np.uint8)
    return np.broadcast_to(img, (h, w, 3)).copy()
