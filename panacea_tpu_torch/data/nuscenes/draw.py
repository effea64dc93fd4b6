"""BEV-layout condition rasterization (NumPy + cv2).

Produces the 19-channel ``cond_img`` the ControlNet consumes
(nuscenes_datasets_video.py:286-341, 353-412; render.py:47-199):

  ch 0-2   painted 3D box corners (per-class colors, depth-sorted,
           washed back face, BGR edge lines)
  ch 3-12  per-class depth-filled 2D bbox maps (depth*3 into white canvas)
  ch 13-15 HD-map polylines (divider red / boundary green / ped-crossing blue
           in BGR, thickness 4, anti-aliased)
  ch 16-18 camera-pose ray-direction image (img2lidar ray deltas, globally
           min-max normalized to 0..255)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np

from panacea_tpu_torch.data.nuscenes.geometry import resample_polyline

CLASS_NAMES = [
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
]

# palette indexed by label+1 (index 0 = background white),
# nuscenes_datasets_video.py:234-254
COLORS = np.array([
    [255, 255, 255], [128, 64, 128], [244, 35, 232], [70, 70, 70],
    [102, 102, 156], [190, 153, 153], [153, 153, 153], [250, 170, 30],
    [220, 220, 0], [107, 142, 35], [152, 251, 152], [0, 130, 180],
    [220, 20, 60], [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
    [0, 80, 100], [0, 0, 230], [119, 11, 32],
])

VIEW_COLORS = {
    "CAM_FRONT": [0, 130, 180],
    "CAM_FRONT_RIGHT": [220, 20, 60],
    "CAM_BACK_RIGHT": [255, 0, 0],
    "CAM_BACK": [0, 0, 142],
    "CAM_BACK_LEFT": [0, 60, 100],
    "CAM_FRONT_LEFT": [119, 11, 32],
}

MAP_COLOR_BGR = {
    "divider": (0, 0, 255),
    "boundary": (0, 255, 0),
    "ped_crossing": (255, 0, 0),
}


def draw_bboxes(shape_hw: Tuple[int, int], bboxes, labels, depths,
                num_classes: int = 10, use_native: bool = True) -> np.ndarray:
    """Per-class depth-filled bbox maps (nuscenes_datasets_video.py:286-309):
    white canvas; each box writes min(existing, depth*3) into its class channel.
    ``use_native=False`` takes the NumPy loop in place of the compiled
    rasterizer (the same pixels; a failed build of the rasterizer raises)."""
    h, w = shape_hw
    img = np.full((h, w, num_classes), 255, dtype=np.uint8)
    if labels is None or len(labels) == 0:
        return img
    labels = np.asarray(labels)
    depths = np.asarray(depths)
    bboxes = np.asarray(bboxes)
    if use_native:
        from panacea_tpu_torch import native

        # clip like the numpy path does implicitly via slicing
        clipped = np.stack([
            np.clip(bboxes[:, 0], 0, w), np.clip(bboxes[:, 1], 0, h),
            np.clip(bboxes[:, 2], 0, w), np.clip(bboxes[:, 3], 0, h),
        ], axis=1)
        native.fill_depth_boxes(img, clipped, labels, depths)
        return img
    for i in range(num_classes):
        mask = labels == i
        if bboxes.size == 0 or mask.sum() == 0:
            continue
        bbs = bboxes[mask]
        deps = depths[mask] * 3
        for j in range(len(bbs)):
            x0, y0, x1, y1 = bbs[j]
            region = img[int(y0):int(y1), int(x0):int(x1), i]
            img[int(y0):int(y1), int(x0):int(x1), i] = np.minimum(
                region, np.uint8(np.clip(deps[j], 0, 255))
            )
    return img


def draw_corners(shape_hw: Tuple[int, int], corners, labels, depths,
                 linewidth: int = 2) -> np.ndarray:
    """Painted 3D boxes (nuscenes_datasets_video.py:311-341): far-to-near,
    washed back face (corner indices 4-7) fill, BGR-flipped edge lines."""
    h, w = shape_hw
    img = np.full((h, w, 3), 255, dtype=np.uint8)
    if corners is None or len(corners) == 0:
        return img
    corners = np.asarray(corners)
    labels = np.asarray(labels)
    depths = np.asarray(depths)
    order = np.argsort(depths)[::-1]
    corners, labels = corners[order], labels[order]
    for j in range(len(corners)):
        color = COLORS[int(labels[j]) + 1]
        color = (int(color[0]), int(color[1]), int(color[2]))
        pts = np.array(
            [[int(corners[j, k, 0]), int(corners[j, k, 1])] for k in (4, 5, 6, 7)]
        ).reshape(-1, 1, 2)
        pts[..., 0] = np.clip(pts[..., 0], 0, w)
        pts[..., 1] = np.clip(pts[..., 1], 0, h)
        wash = (int(color[0] * 0.5 + 127.5), int(color[1] * 0.5 + 127.5),
                int(color[2] * 0.5 + 127.5))
        cv2.fillPoly(img, [pts], wash)
        bgr = color[::-1]
        for i in range(4):
            cv2.line(
                img,
                (int(corners[j][i][0]), int(corners[j][i][1])),
                (int(corners[j][i + 4][0]), int(corners[j][i + 4][1])),
                bgr, linewidth,
            )
        for face in (corners[j][:4], corners[j][4:]):
            prev = face[-1]
            for c in face:
                cv2.line(img, (int(prev[0]), int(prev[1])),
                         (int(c[0]), int(c[1])), bgr, linewidth)
                prev = c
    return img


def draw_map_polylines(
    shape_hw: Tuple[int, int],
    vectors: Dict[int, List[np.ndarray]],
    lidar2img: np.ndarray,
    id2cat: Dict[int, str],
    thickness: int = 4,
    num_interp: int = 200,
) -> np.ndarray:
    """Project ego-frame map polylines into one camera and draw AA lines on a
    white canvas (render.py:47-199)."""
    h, w = shape_hw
    img = np.full((h, w, 3), 255, dtype=np.uint8)
    for label, vector_list in vectors.items():
        color = MAP_COLOR_BGR[id2cat[int(label)]]
        for vec in vector_list:
            poly = np.asarray(vec, dtype=np.float64)
            if poly.shape[1] == 2:
                poly = np.concatenate(
                    [poly, np.zeros((len(poly), 1))], axis=1
                )
            poly = resample_polyline(poly, num_interp)
            pts4 = np.concatenate([poly, np.ones((len(poly), 1))], axis=1)
            cam = (np.asarray(lidar2img) @ pts4.T)[:3].T
            valid_nan = ~np.isnan(cam).any(axis=1)
            cam = cam[valid_nan]
            if len(cam) == 0:
                continue
            depth = cam[:, 2]
            # guard the division: zero/negative-depth points are discarded
            # by the `ok` mask below, but dividing by them first emits
            # divide-by-zero RuntimeWarnings in the debug path
            safe = np.where(np.abs(depth) > 1e-6, depth, 1e-6)
            uv = cam[:, :2] / safe[:, None]
            ok = (
                (uv[:, 0] >= 0) & (uv[:, 0] < w - 1)
                & (uv[:, 1] >= 0) & (uv[:, 1] < h - 1) & (depth > 0)
            )
            if ok.sum() == 0:
                continue
            uvi = np.round(uv[ok]).astype(np.int32)
            for i in range(len(uvi) - 1):
                cv2.line(img, tuple(uvi[i]), tuple(uvi[i + 1]), color,
                         thickness, lineType=cv2.LINE_AA)
    return img


def render_directions(
    shape_hw: Tuple[int, int], img2lidars: Sequence[np.ndarray]
) -> List[np.ndarray]:
    """Per-pixel camera ray-direction images, jointly normalized across views
    (nuscenes_datasets_video.py:382-412)."""
    eps = 1e-5
    h, w = shape_hw
    n = len(img2lidars)
    coords_h = np.arange(h)
    coords_w = np.arange(w)
    coords_d = np.array([1.0, 2.0])
    coords = np.stack(np.meshgrid(coords_w, coords_h, coords_d)).transpose(
        (1, 2, 3, 0)
    )  # (W, H, D, 3)
    coords = np.concatenate([coords, np.ones_like(coords[..., :1])], -1)
    coords[..., :2] = coords[..., :2] * np.maximum(coords[..., 2:3], eps)
    i2l = np.asarray(img2lidars).reshape(n, 1, 1, 1, 4, 4)
    pts = coords.reshape(1, w, h, 2, 4, 1)
    c3d = np.matmul(i2l, pts).squeeze(-1)[..., :3]  # (N, W, H, D, 3)
    c3d = c3d.transpose((0, 2, 1, 3, 4))  # (N, H, W, D, 3)
    directions = c3d[:, :, :, 1, :] - c3d[:, :, :, 0, :]
    dmin, dmax = directions.min(), directions.max()
    out = (directions - dmin) / max(dmax - dmin, eps) * 255
    return [v.astype(np.uint8) for v in out]


def render_view_colors(
    shape_hw: Tuple[int, int], camera_views: Sequence[str]
) -> List[np.ndarray]:
    """Fallback per-view constant-color canvases (render_pose=False path,
    nuscenes_datasets_video.py:343-351)."""
    h, w = shape_hw
    return [
        (np.zeros((h, w, 3)) + np.array(VIEW_COLORS[v])[None, None]).astype(
            np.uint8
        )
        for v in camera_views
    ]
