"""Geometry helpers (pure NumPy — replaces shapely/pyquaternion usages).

* 3D box corners in the mmdet3d LiDAR convention (bottom-center origin,
  indices 0-3 on the -x face, 4-7 on the +x face — the order draw_corners
  depends on, nuscenes_datasets_video.py:311-341)
* arc-length polyline resampling (render.py:31-45 interp_fixed_num)
* convex-hull-clipped 2D box from projected corners
  (nuscenes_datasets_video.py:26-56 post_process_coords)
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# unit-cube corner order matching mmdet3d LiDARInstance3DBoxes.corners
_CORNERS_NORM = np.array(
    [
        [0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0],
        [1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0],
    ],
    dtype=np.float64,
) - np.array([0.5, 0.5, 0.0])


def box3d_corners(boxes: np.ndarray) -> np.ndarray:
    """boxes: (N, >=7) rows (x, y, z, dx, dy, dz, yaw, ...) with bottom-center
    origin -> corners (N, 8, 3)."""
    boxes = np.asarray(boxes, dtype=np.float64)
    if boxes.size == 0:
        return np.zeros((0, 8, 3))
    centers = boxes[:, :3]
    dims = boxes[:, 3:6]
    yaws = boxes[:, 6]
    corners = dims[:, None, :] * _CORNERS_NORM[None]  # (N, 8, 3)
    cos, sin = np.cos(yaws), np.sin(yaws)
    rot = np.zeros((len(boxes), 3, 3))
    rot[:, 0, 0] = cos
    rot[:, 0, 1] = -sin
    rot[:, 1, 0] = sin
    rot[:, 1, 1] = cos
    rot[:, 2, 2] = 1.0
    corners = np.einsum("nij,nkj->nki", rot, corners)
    return corners + centers[:, None, :]


def resample_polyline(points: np.ndarray, num_pts: int = 200) -> np.ndarray:
    """Arc-length-uniform resampling of a polyline (N, D) -> (num_pts, D)."""
    points = np.asarray(points, dtype=np.float64)
    if len(points) == 1:
        return np.repeat(points, num_pts, axis=0)
    seg = np.linalg.norm(np.diff(points, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1]
    if total < 1e-12:
        return np.repeat(points[:1], num_pts, axis=0)
    targets = np.linspace(0.0, total, num_pts)
    idx = np.clip(np.searchsorted(cum, targets, side="right") - 1, 0,
                  len(seg) - 1)
    frac = (targets - cum[idx]) / np.maximum(seg[idx], 1e-12)
    return points[idx] + frac[:, None] * (points[idx + 1] - points[idx])


def _convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; points (N, 2) -> hull vertices CCW."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: List[np.ndarray] = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: List[np.ndarray] = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1])


def _clip_polygon_to_rect(poly: np.ndarray, xmin, ymin, xmax, ymax) -> np.ndarray:
    """Sutherland-Hodgman clip of polygon (N,2) against an axis box."""
    def clip_edge(pts, inside, intersect):
        if len(pts) == 0:
            return pts
        out = []
        for i in range(len(pts)):
            cur, prev = pts[i], pts[i - 1]
            cin, pin = inside(cur), inside(prev)
            if cin:
                if not pin:
                    out.append(intersect(prev, cur))
                out.append(cur)
            elif pin:
                out.append(intersect(prev, cur))
        return np.asarray(out) if out else np.zeros((0, 2))

    def ix(p, q, axis, val):
        t = (val - p[axis]) / (q[axis] - p[axis])
        return p + t * (q - p)

    poly = clip_edge(poly, lambda p: p[0] >= xmin, lambda p, q: ix(p, q, 0, xmin))
    poly = clip_edge(poly, lambda p: p[0] <= xmax, lambda p, q: ix(p, q, 0, xmax))
    poly = clip_edge(poly, lambda p: p[1] >= ymin, lambda p, q: ix(p, q, 1, ymin))
    poly = clip_edge(poly, lambda p: p[1] <= ymax, lambda p, q: ix(p, q, 1, ymax))
    return poly


def post_process_coords(
    corner_coords: np.ndarray, imsize: Tuple[int, int] = (1600, 900)
) -> Optional[Tuple[float, float, float, float]]:
    """Intersect the convex hull of projected box corners with the image canvas;
    None if empty (nuscenes_datasets_video.py:26-56)."""
    hull = _convex_hull(np.asarray(corner_coords, dtype=np.float64))
    if len(hull) == 0:
        return None
    if len(hull) <= 2:
        # degenerate: clip the raw points to the canvas
        inside = hull[
            (hull[:, 0] >= 0) & (hull[:, 0] <= imsize[0])
            & (hull[:, 1] >= 0) & (hull[:, 1] <= imsize[1])
        ]
        if len(inside) == 0:
            return None
        clipped = inside
    else:
        clipped = _clip_polygon_to_rect(hull, 0, 0, imsize[0], imsize[1])
        if len(clipped) == 0:
            return None
    return (
        float(clipped[:, 0].min()),
        float(clipped[:, 1].min()),
        float(clipped[:, 0].max()),
        float(clipped[:, 1].max()),
    )


def project_boxes_to_views(
    corners_3d: np.ndarray,
    labels_3d: np.ndarray,
    lidar2imgs: np.ndarray,
    shape_hw: Tuple[int, int],
    depth_clip: Tuple[float, float] = (0.1, 51.2),
):
    """Project 3D corners into each of 6 cameras (nuscenes_datasets_video.py:
    414-475): returns per-view lists of (bbox2d, depth, label, corners2d).
    Boxes covering nearly the whole canvas are dropped: the reference's
    absolute margin (>W-100 x >H-100 px at its 512x256 per-view canvas,
    :458) is applied scale-faithfully — identical behavior at production
    geometry, proportional at the tiny test canvases where the raw
    constant would reject EVERY visible box (H-100 < 0)."""
    H, W = shape_hw
    drop_w = W * (512.0 - 100.0) / 512.0
    drop_h = H * (256.0 - 100.0) / 256.0
    num_box = corners_3d.shape[0]
    pts_4d = np.concatenate(
        [corners_3d.reshape(-1, 3), np.ones((num_box * 8, 1))], axis=-1
    )
    out = {"bbox2d": [], "depth2d": [], "label2d": [], "corners2d": []}
    for i in range(len(lidar2imgs)):
        pts_2d = pts_4d @ np.asarray(lidar2imgs[i]).T
        depth = np.clip(pts_2d[:, 2], depth_clip[0], depth_clip[1])
        uv = pts_2d[:, :2] / depth[:, None]
        uv = uv.reshape(num_box, 8, 2)
        depth = depth.reshape(num_box, 8)
        mask = depth.mean(axis=1) > 0.1
        bboxes, labels, depths, corners = [], [], [], []
        if mask.sum():
            for j in np.where(mask)[0]:
                coords = post_process_coords(uv[j], imsize=(W, H))
                if coords is None:
                    continue
                x0, y0, x1, y1 = coords
                if (x1 - x0) > drop_w and (y1 - y0) > drop_h:
                    continue
                bboxes.append([x0, y0, x1, y1])
                labels.append(labels_3d[j])
                depths.append(depth[j].mean())
                corners.append(uv[j].copy())
        out["bbox2d"].append(np.asarray(bboxes))
        out["depth2d"].append(np.asarray(depths))
        out["label2d"].append(np.asarray(labels))
        out["corners2d"].append(np.asarray(corners))
    return out
