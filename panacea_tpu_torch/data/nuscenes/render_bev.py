"""BEV debug rendering, the map/GT visualization tail of the reference
(counterpart of ``panacea_tpu/data/nuscenes/render_bev.py``, the same
functions and pixels; this package's own copy, as the port imports nothing
of the JAX package).

Port of sgm/data/nuscenes_video/render.py:123-314
(Renderer.render_bev_from_vectors / render_camera_views_from_vectors /
render_bev_from_mask + the show_gt driver): top-down arrow plots of the
vectorized map elements, per-camera white-canvas polyline projections, and
colored semantic-mask images. The reference draws the BEV with matplotlib
quiver; here cv2 arrowedLine draws the same directed polylines (no
matplotlib figure machinery, same colors/geometry).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from panacea_tpu_torch.data.nuscenes.draw import MAP_COLOR_BGR, draw_map_polylines

CAM_NAMES = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
             "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT")


def render_bev_from_vectors(
    vectors: Dict[int, List[np.ndarray]],
    id2cat: Dict[int, str],
    roi_size: Tuple[float, float] = (60.0, 30.0),
    px_per_m: float = 10.0,
) -> np.ndarray:
    """Top-down BGR image of directed map polylines (render.py:139-166).

    vectors: {class id: [poly (P, >=2) ego-frame meters]}. Ego at center,
    +x up (the reference's flipud convention), arrows along each segment."""
    import cv2

    w = int(roi_size[0] * px_per_m)
    h = int(roi_size[1] * px_per_m)
    img = np.full((h, w, 3), 255, np.uint8)

    def to_px(pts):
        x = (pts[:, 0] + roi_size[0] / 2) * px_per_m
        y = h - (pts[:, 1] + roi_size[1] / 2) * px_per_m
        return np.stack([x, y], -1).astype(np.int32)

    for label, vector_list in vectors.items():
        color = MAP_COLOR_BGR.get(id2cat.get(int(label), ""), (0, 0, 0))
        for vec in vector_list:
            p = to_px(np.asarray(vec, np.float32)[:, :2])
            for a, b in zip(p[:-1], p[1:]):
                cv2.arrowedLine(img, tuple(a), tuple(b), color, 2,
                                tipLength=0.2)
    # ego marker (reference pastes car.png; a filled rectangle here)
    cx, cy = w // 2, h // 2
    cv2.rectangle(img, (cx - int(1.5 * px_per_m), cy - int(1.2 * px_per_m)),
                  (cx + int(1.5 * px_per_m), cy + int(1.2 * px_per_m)),
                  (80, 80, 80), -1)
    return img


def render_bev_from_mask(semantic_mask: np.ndarray,
                         id2cat: Dict[int, str]) -> np.ndarray:
    """(C, H, W) {0,1} semantic mask -> colored BGR image
    (render.py:200-226): drivable area painted first, classes on top,
    flipud like the reference."""
    c, h, w = semantic_mask.shape
    img = np.full((h, w, 3), 255, np.uint8)
    order = sorted(range(c),
                   key=lambda i: 0 if id2cat.get(i) == "drivable_area" else 1)
    for label in order:
        cat = id2cat.get(label, "")
        color = MAP_COLOR_BGR.get(cat, (0, 0, 0))
        img[semantic_mask[label] == 1] = color
    return img[::-1].copy()


def render_camera_views_from_vectors(
    vectors: Dict[int, List[np.ndarray]],
    lidar2imgs: Sequence[np.ndarray],
    id2cat: Dict[int, str],
    img_hw: Tuple[int, int] = (256, 512),
    thickness: int = 2,
) -> List[np.ndarray]:
    """Project map polylines into every camera on white canvases
    (render.py:169-198), via the production polyline projector."""
    return [draw_map_polylines(img_hw, vectors, np.asarray(l2i), id2cat,
                               thickness=thickness)
            for l2i in lidar2imgs]


def save_bev_debug(
    vectors: Dict[int, List[np.ndarray]],
    lidar2imgs: Sequence[np.ndarray],
    id2cat: Dict[int, str],
    out_dir: str,
    roi_size: Tuple[float, float] = (60.0, 30.0),
    img_hw: Tuple[int, int] = (256, 512),
    semantic_mask: np.ndarray = None,
) -> List[str]:
    """show_gt equivalent (render.py:229-314): writes map.jpg + per-camera
    <CAM>.jpg (+ semantic_map.jpg when a mask is given). Returns paths."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    p = os.path.join(out_dir, "map.jpg")
    cv2.imwrite(p, render_bev_from_vectors(vectors, id2cat, roi_size))
    paths.append(p)
    for name, img in zip(CAM_NAMES, render_camera_views_from_vectors(
            vectors, lidar2imgs, id2cat, img_hw)):
        p = os.path.join(out_dir, f"{name}.jpg")
        cv2.imwrite(p, img)
        paths.append(p)
    if semantic_mask is not None:
        p = os.path.join(out_dir, "semantic_map.jpg")
        cv2.imwrite(p, render_bev_from_mask(semantic_mask, id2cat))
        paths.append(p)
    return paths
