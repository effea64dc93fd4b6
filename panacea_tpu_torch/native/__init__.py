"""ctypes binding of the rasterizer (``rasterizer.cpp``), built with ``g++``.

The port's own copy of ``panacea_tpu/native``. The library is built at first
use into ``panacea_tpu_torch/_build/`` (listed in .gitignore) under a name
that carries a hash of the source, so a changed source builds anew and no
``.so`` is committed. A missing compiler or a failed build raises: callers
that want the NumPy path ask for it (``draw_bboxes(..., use_native=False)``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "rasterizer.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")
CXX = "g++"


def build() -> str:
    """Compile the rasterizer where it is not built yet; the library's path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_ROOT, f"librasterizer-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [CXX, "-O3", "-shared", "-fPIC", SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"{CXX} not found: the rasterizer is built from "
                           f"{SOURCE} at first use and needs a C++ compiler") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process writes the same bytes
    return out


@functools.cache
def get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.fill_depth_boxes.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, i64p, f32p, ctypes.c_int64,
    ]
    lib.fill_depth_boxes.restype = None
    lib.draw_polyline.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int64,
        ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_int,
    ]
    lib.draw_polyline.restype = None
    lib.fill_convex_poly.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int64,
        ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
    ]
    lib.fill_convex_poly.restype = None
    return lib


def _check_canvas(img: np.ndarray, channels=None) -> None:
    if (img.dtype != np.uint8 or img.ndim != 3 or not img.flags.c_contiguous
            or (channels is not None and img.shape[2] != channels)):
        raise ValueError(f"rasterizer: canvas must be a C-contiguous uint8 (H, W, "
                         f"{channels or 'C'}) array, got {img.dtype} {img.shape}")


def fill_depth_boxes(img: np.ndarray, boxes, labels, depths) -> None:
    """In place: min(existing, depth * 3) into channel ``labels[i]`` inside
    each box (x0, y0, x1, y1) of the (H, W, C) uint8 canvas."""
    _check_canvas(img)
    boxes = np.ascontiguousarray(np.asarray(boxes, dtype=np.float32).reshape(-1, 4))
    labels = np.ascontiguousarray(np.asarray(labels, dtype=np.int64).reshape(-1))
    depths = np.ascontiguousarray(np.asarray(depths, dtype=np.float32).reshape(-1))
    if not len(boxes) == len(labels) == len(depths):
        raise ValueError(f"rasterizer: {len(boxes)} boxes, {len(labels)} labels, "
                         f"{len(depths)} depths")
    get_lib().fill_depth_boxes(
        img, img.shape[0], img.shape[1], img.shape[2],
        boxes, labels, depths, len(labels),
    )


def draw_polyline(img: np.ndarray, pts, color_bgr, thickness: int) -> None:
    """In place: a solid polyline of ``thickness`` with round joins on the
    (H, W, 3) uint8 canvas; ``pts`` (K, 2) pixel coordinates."""
    _check_canvas(img, 3)
    pts = np.ascontiguousarray(np.asarray(pts, dtype=np.int32).reshape(-1, 2))
    get_lib().draw_polyline(
        img, img.shape[0], img.shape[1], pts, len(pts),
        int(color_bgr[0]), int(color_bgr[1]), int(color_bgr[2]),
        int(thickness),
    )


def fill_convex_poly(img: np.ndarray, pts, color) -> None:
    """In place: scanline fill of the convex polygon ``pts`` (K, 2)."""
    _check_canvas(img, 3)
    pts = np.ascontiguousarray(np.asarray(pts, dtype=np.int32).reshape(-1, 2))
    get_lib().fill_convex_poly(
        img, img.shape[0], img.shape[1], pts, len(pts),
        int(color[0]), int(color[1]), int(color[2]),
    )
