"""Output writers: PNG grids, GIFs, and per-view per-frame JPEGs in the
Gen-nuScenes layout the StreamPETR eval harness consumes
(inference.py:116-205; metrics/.../nuscenes_dataset.py:222 expects
``<view>_<file-stem>/_00000<i>.jpg``).

All inputs channels-last float in [-1, 1] (or [0, 1] for condition images).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
from PIL import Image

PANORAMA_VIEWS = [
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_FRONT_LEFT",
]


def to_uint8(x: np.ndarray, value_range=(-1.0, 1.0)) -> np.ndarray:
    lo, hi = value_range
    x = np.clip(np.asarray(x, dtype=np.float32), lo, hi)
    x = (x - lo) / (hi - lo)
    return (x * 255).astype(np.uint8)


def _displayable(x: np.ndarray) -> np.ndarray:
    """Multi-channel condition stacks (19ch) display as the min over the
    10 depth channels (inference.py:131-133, 170-172)."""
    if x.shape[-1] > 4:
        return x[..., :10].min(axis=-1)
    return x


def save_image_grid(frames: np.ndarray, path: str,
                    value_range=(-1.0, 1.0)) -> None:
    """(T, H, W, C) -> vertically stacked PNG grid (inference.py:153-177)."""
    u8 = to_uint8(_displayable(frames), value_range)
    grid = np.concatenate(list(u8), axis=0)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(grid.squeeze()).save(path)


def save_gif(frames: np.ndarray, path: str, fps: float = 4.0,
             value_range=(-1.0, 1.0)) -> None:
    """(T, H, W, C) -> looping GIF (inference.py:126-151)."""
    u8 = to_uint8(_displayable(frames), value_range)
    imgs = [Image.fromarray(f.squeeze()) for f in u8]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    imgs[0].save(
        path, save_all=True, append_images=imgs[1:],
        duration=int(1000 / fps), loop=0,
    )


def save_frames_gen_nuscenes(
    frames: np.ndarray,
    root: str,
    filenames: List[List[str]],
    view_width: int = 512,
) -> List[str]:
    """Split the panorama into views and write the Gen-nuScenes layout:
    ``<root>/<CAM>_<stem>/_00000<i>.jpg`` keyed by the LAST frame's filenames
    (inference.py:179-205). frames: (T, H, 6*view_width, 3) in [-1,1]."""
    t = frames.shape[0]
    u8 = to_uint8(frames)
    out_dirs = []
    last = filenames[-1]
    for vi in range(6):
        stem = os.path.basename(str(last[vi])).rsplit(".", 1)[0]
        parts = stem.split("__")
        cam = parts[-2] if len(parts) >= 2 else PANORAMA_VIEWS[vi]
        vid_dir = os.path.join(root, f"{cam}_{stem}")
        os.makedirs(vid_dir, exist_ok=True)
        out_dirs.append(vid_dir)
        for fi in range(t):
            tile = u8[fi, :, vi * view_width:(vi + 1) * view_width]
            Image.fromarray(tile).save(
                os.path.join(vid_dir, f"_{fi:06d}.jpg")
            )
    return out_dirs


def log_outputs(
    log: Dict[str, np.ndarray],
    root: str,
    filenames: List[List[str]],
    num_frames: int = 8,
    view_width: int = 512,
    save_gifs: bool = True,
    save_grids: bool = True,
    save_frames: bool = True,
) -> None:
    """Write everything the reference writes per batch
    (inference.py:304-308)."""
    stem = os.path.basename(str(filenames[-1][0])).rsplit(".", 1)[0]
    for k, v in log.items():
        v = np.asarray(v)
        frames = v.reshape((-1, num_frames) + v.shape[1:])[0]
        rng = (0.0, 1.0) if k == "cond_img" else (-1.0, 1.0)
        if save_grids and k not in ("cond_img", "reconstructions"):
            save_image_grid(frames, os.path.join(root, k, stem + ".png"), rng)
        if save_gifs and k not in ("cond_img", "reconstructions"):
            save_gif(frames, os.path.join(root, k, stem + ".gif"), 4.0, rng)
    if save_frames and "samples" in log:
        v = np.asarray(log["samples"])
        frames = v.reshape((-1, num_frames) + v.shape[1:])[0]
        save_frames_gen_nuscenes(
            frames, os.path.join(root, "gen-nuscenes"), filenames, view_width
        )
