"""Ground-truth future trajectories from the temporal infos.

The port's own copy of ``panacea_tpu/data/nuscenes/trajectory.py``
(reference ``NuScenesTraj``, trajectory_api.py:12-54, without the nuScenes
devkit): each annotation's global position over the next ``pred_steps``
key frames (6 s at 2 Hz), mapped into the current frame's ego frame by
``ego_pose_inv`` and zero-padded to a fixed length with a validity mask.

The future positions come from the infos themselves: each frame's
``gt_boxes`` are in the lidar frame, so global = ego2global @ lidar2ego @
centre, matched across frames by ``instance_inds``. A future stops at a
scene boundary or at the first frame that lacks the instance, as the
devkit helper stops at a broken annotation chain.

The reference's frame quirk is kept: the targets land in the ego frame
through the 2 x 2 xy rotation of ``ego_pose_inv`` (trajectory_api.py:39),
while the motion head anchors its predictions at box centres in the lidar
frame (petr_motion_head.py:669-671). The reference trains and evaluates
with that difference, and so do both packages.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from panacea_tpu_torch.data.nuscenes.calib import quat_to_rotmat


def _pose(info: Dict[str, Any], rot: str, trans: str) -> np.ndarray:
    """The 4 x 4 of one quaternion pose of ``info``, identity without it
    (the synthetic scenes put everything in one frame)."""
    m = np.eye(4)
    if rot in info:
        m[:3, :3] = quat_to_rotmat(info[rot])
        m[:3, 3] = np.asarray(info[trans])
    return m


def _ego_to_global(info: Dict[str, Any]) -> np.ndarray:
    return _pose(info, "ego2global_rotation", "ego2global_translation")


def _lidar_to_global(info: Dict[str, Any]) -> np.ndarray:
    return _ego_to_global(info) @ _pose(info, "lidar2ego_rotation", "lidar2ego_translation")


def future_trajectories(infos: List[Dict[str, Any]], idx: int,
                        pred_steps: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    """The future xy of every box of ``infos[idx]``, in that frame's ego
    frame: (fut_traj (G, pred_steps, 2), valid_mask (G, pred_steps, 2)).
    The infos carry ``instance_inds``."""
    info = infos[idx]
    inds = np.asarray(info["instance_inds"])
    fut = np.zeros((len(inds), pred_steps, 2))
    valid = np.zeros((len(inds), pred_steps, 2))
    ego_pose_inv = np.linalg.inv(_ego_to_global(info))

    # instance -> global centre, one map a future frame of the same scene
    future_maps = []
    for s in range(1, pred_steps + 1):
        j = idx + s
        if j >= len(infos) or infos[j].get("scene_token") != info.get("scene_token"):
            break
        l2g = _lidar_to_global(infos[j])
        centres = np.asarray(infos[j]["gt_boxes"])[:, :3] @ l2g[:3, :3].T + l2g[:3, 3]
        future_maps.append(dict(zip(np.asarray(infos[j]["instance_inds"]).tolist(), centres)))

    for bi, ind in enumerate(inds.tolist()):
        for s, fmap in enumerate(future_maps):
            if ind not in fmap:
                break
            fut[bi, s] = fmap[ind][:2] @ ego_pose_inv[:2, :2].T + ego_pose_inv[:2, 3]
            valid[bi, s] = 1.0
    return fut, valid
