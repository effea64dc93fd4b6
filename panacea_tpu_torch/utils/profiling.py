"""Phase timer (counterpart of ``Timer`` in ``panacea_tpu/utils/profiling.py``).

PyTorch returns from a CUDA call before the card has finished, so the timer
waits for the device (``torch.cuda.synchronize``) before each reading of the
clock when it is given a CUDA device; a phase's time is then the time of the
work it started, not of its enqueueing.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class Timer:
    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else None
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    def _clock(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def report(self) -> str:
        return " ".join(
            f"{k}: {self.last[k]:.2f}s (avg {self.mean(k):.2f}s)"
            for k in self.totals
        )
