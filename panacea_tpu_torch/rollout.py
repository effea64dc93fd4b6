"""Two-stage autoregressive long-video rollout (counterpart of
``panacea_tpu/rollout.py``).

The reference extends video beyond 8 frames at the *pipeline* level: the last
generated frame becomes the next clip's conditioning frame
(README.md:85-88; conditioning mechanics: final_cond_zero +
``use_last_frame`` flag, nuscenes_datasets_video.py:559-572, and the
shared-noise init, diffusion.py:244-249). This module implements that loop:

  window 0: condition on the dataset's key frame (use_last_frame placement)
  window k>0: condition on window k-1's LAST GENERATED frame, placed at
              slot 0 of the new window (windows overlap by one frame)

Under a grid (``DiffusionEngine3D.set_grid``) the same calls sample each
window over the ranks: ``log_images`` returns the whole window on every
rank, so every rank conditions the next window on the same frame.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch


def rollout(
    engine,
    dataset,
    start_idx: int,
    num_windows: int,
    generator: Optional[torch.Generator] = None,
    num_steps: Optional[int] = None,
) -> Dict[str, Any]:
    """Generate ``num_windows`` overlapping clips autoregressively.

    ``generator`` (on the engine's device) is one stream of random numbers
    that every window advances, where the JAX rollout splits a key per
    window; the default is a fresh generator seeded 0.

    Returns {'frames': (num_total_frames, H, W, 3) in [-1,1], 'windows': list
    of per-window sample stacks, 'filenames': accumulated}.
    """
    t = engine.num_frames
    if generator is None:
        generator = torch.Generator(device=engine.device).manual_seed(0)
    all_frames: List[np.ndarray] = []
    window_logs = []
    filenames: List[List[str]] = []
    prev_last_frame: Optional[np.ndarray] = None

    idx = start_idx
    for w in range(num_windows):
        item = dataset[idx]
        batch = {
            "jpg": item["jpg"][None],
            "cond_img": item["cond_img"][None],
            "final_cond_zero": item["final_cond_zero"][None],
            "txt": [item["txt"]],
        }
        # Windows k>0 condition on the previous window's generated last frame,
        # placed in slot 0 (windows overlap by one frame). The shared-noise
        # init must then anchor to concat[0] — the default concat[-1]
        # (reference quirk, diffusion.py:244-249) would anchor to an encoded
        # zero frame and silently no-op on continuation windows.
        share_noise_frame = -1
        if prev_last_frame is not None:
            fcz = np.zeros_like(item["final_cond_zero"])
            fcz[0] = prev_last_frame
            batch["final_cond_zero"] = fcz[None]
            share_noise_frame = 0
        log = engine.log_images(batch, N=1, generator=generator, num_steps=num_steps,
                                share_noise_frame=share_noise_frame)
        samples = np.asarray(torch.as_tensor(log["samples"]).float().cpu())  # (T, H, W, 3)
        window_logs.append(log)
        filenames.extend(item["filenames"])
        prev_last_frame = samples[-1]
        if w == 0:
            all_frames.extend(list(samples))
        else:
            all_frames.extend(list(samples[1:]))  # drop the overlapping frame
        # advance the dataset window by T-1 frames (one-frame overlap)
        idx = min(idx + (t - 1), len(dataset) - 1)

    return {
        "frames": np.stack(all_frames),
        "windows": window_logs,
        "filenames": filenames,
    }
