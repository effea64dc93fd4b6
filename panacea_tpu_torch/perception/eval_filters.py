"""Ground-truth and prediction filters of the camera-only eval protocols.

Counterpart of ``panacea_tpu/perception/eval_filters.py``, a NumPy copy
(the generation side's nuscenes_eval.py; the devkit's database lookups
become arrays from the infos, the geometric tests are the reference's):

- ``center_in_image`` (:152-172): the centre projects inside the image,
  deeper than 1 m, every tested point more than 0.1 m in front;
- ``exist_corners_in_image_but_not_all`` (:175-199): partly visible boxes;
- ``filter_boxes_by_visibility`` (:252-282): the boxes whose visibility
  token is the requested level;
- ``visible_camera_count`` and ``filter_boxes_by_overlap`` (:295-384): the
  boxes whose centre more than one camera sees;
- ``corners_cam``: the boxes' corners in a camera's frame.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from panacea_tpu_torch.data.nuscenes.geometry import box3d_corners

ALL = "all"
ANY = "any"
NONE = "none"


def _view_points(pts_cam: np.ndarray, intrinsic: np.ndarray) -> np.ndarray:
    """(3, P) camera-frame -> (2, P) pixels (devkit view_points,
    normalize=True)."""
    viewpad = np.eye(3)
    viewpad[:intrinsic.shape[0], :intrinsic.shape[1]] = intrinsic[:3, :3]
    p = viewpad @ pts_cam
    return p[:2] / np.maximum(p[2:3], 1e-9)


def center_in_image(center_cam: np.ndarray, intrinsic: np.ndarray,
                    imsize: Tuple[int, int], vis_level: str = ANY) -> bool:
    """center_cam (3,) in the CAMERA frame; imsize (width, height)."""
    c = np.asarray(center_cam, np.float64).reshape(3, 1)
    img = _view_points(c, np.asarray(intrinsic))
    visible = ((img[0] > 0) & (img[0] < imsize[0])
               & (img[1] > 0) & (img[1] < imsize[1]) & (c[2] > 1))
    in_front = c[2] > 0.1
    if vis_level == ALL:
        return bool(visible.all() and in_front.all())
    if vis_level == ANY:
        return bool(visible.any() and in_front.all())
    if vis_level == NONE:
        return True
    raise ValueError(vis_level)


def exist_corners_in_image_but_not_all(
        corners_cam: np.ndarray, intrinsic: np.ndarray,
        imsize: Tuple[int, int]) -> bool:
    """corners_cam (3, 8) camera frame."""
    c = np.asarray(corners_cam, np.float64)
    img = _view_points(c, np.asarray(intrinsic))
    visible = ((img[0] > 0) & (img[0] < imsize[0])
               & (img[1] > 0) & (img[1] < imsize[1]) & (c[2] > 1))
    in_front = c[2] > 0.1
    return bool(visible.any() and not visible.all() and in_front.all())


def filter_boxes_by_visibility(
    boxes: np.ndarray,
    visibilities: Sequence[str],
    visibility: str = "1",
) -> np.ndarray:
    """Boolean keep-mask: visibility token equality
    (filter_eval_boxes_by_visibility semantics)."""
    return np.asarray([v == visibility for v in visibilities], bool)


def visible_camera_count(
    boxes7: np.ndarray,
    extrinsics: np.ndarray,
    intrinsics: np.ndarray,
    imsize: Tuple[int, int],
    vis_level: str = ANY,
) -> np.ndarray:
    """Per-box count of cameras whose image contains the box center.
    boxes7 (G, 7) in the lidar frame; extrinsics (N, 4, 4) lidar->cam;
    intrinsics (N, 4, 4) viewpads; imsize (width, height)."""
    g = len(boxes7)
    n = len(extrinsics)
    counts = np.zeros((g,), np.int64)
    if g == 0:
        return counts
    centers = np.concatenate(
        [np.asarray(boxes7)[:, :3], np.ones((g, 1))], -1)
    for ci in range(n):
        cam = (extrinsics[ci] @ centers.T)[:3]  # (3, G)
        for bi in range(g):
            if center_in_image(cam[:, bi], intrinsics[ci], imsize,
                               vis_level):
                counts[bi] += 1
    return counts


def filter_boxes_by_overlap(
    boxes7: np.ndarray,
    extrinsics: np.ndarray,
    intrinsics: np.ndarray,
    imsize: Tuple[int, int],
) -> np.ndarray:
    """Keep-mask for the camera-overlap subset: center visible in >1
    camera (filter_eval_boxes_by_overlap, :352-364 ``count > 1``)."""
    return visible_camera_count(boxes7, extrinsics, intrinsics, imsize) > 1


def corners_cam(boxes7: np.ndarray, extrinsic: np.ndarray) -> np.ndarray:
    """(G, 7) lidar boxes -> (G, 3, 8) camera-frame corners."""
    corners = box3d_corners(np.asarray(boxes7))  # (G, 8, 3)
    g = corners.shape[0]
    h = np.concatenate([corners, np.ones((g, 8, 1))], -1)
    return np.einsum("ij,gkj->gik", extrinsic, h)[:, :3]
