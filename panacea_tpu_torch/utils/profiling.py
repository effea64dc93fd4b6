"""Phase timer and trace capture (counterpart of
``panacea_tpu/utils/profiling.py``: ``Timer``, ``trace``, and
``trace_summary`` in place of ``hlo_stats_summary``).

PyTorch returns from a CUDA call before the card has finished, so the timer
waits for the device (``torch.cuda.synchronize``) before each reading of the
clock when it is given a CUDA device; a phase's time is then the time of the
work it started, not of its enqueueing.

``trace`` records the host and, where there is a card, the device under
``torch.profiler`` and writes a Chrome trace under its directory;
``trace_summary`` reads the newest one back and sums its device time into
the JAX package's buckets (``_BUCKET_OF`` there: matmul, pallas, copies,
elementwise, reduces, other; "pallas" holds the port's hand-written
kernels, where the JAX package's Pallas calls land), into the port's finer
buckets (``BUCKETS``), and by the port's kernels' symbols (``pn_*``).
``device_summary`` does the summing for any list of (kernel name, ms), so
that a caller holding the profiler's events needs no file.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import time
from collections import defaultdict
from typing import Dict, Iterable, Optional, Tuple

import torch

# the port's buckets of device time: the first whose keys one is in a
# kernel's lowercased name takes it, else "other" (the port's kernels by
# their own symbols first: PyTorch's SDPA has a flash_fwd_kernel too)
BUCKETS = (("flash_attention_bwd", ("pn_flash_bwd",)), ("flash_attention", ("pn_flash_",)),
           ("geglu_bwd", ("pn_geglu_bwd",)), ("geglu", ("pn_geglu_fwd",)),
           ("sdpa", ("fmha", "flash", "attention", "softmax")),
           ("conv", ("conv", "cudnn", "implicit", "dgrad", "wgrad", "nhwc")),
           ("matmul", ("gemm", "xmma", "cutlass", "gemv", "matmul", "sm90")),
           ("norm_reduce", ("reduce", "norm", "welford")),
           ("grid_sample", ("grid_sampler",)),
           ("elementwise", ("elementwise", "vectorized", "unrolled", "copy", "cat")))
# the port's bucket -> the JAX package's (panacea_tpu/utils/profiling.py:58-73)
JAX_BUCKET = {"flash_attention_bwd": "pallas", "flash_attention": "pallas",
              "geglu_bwd": "pallas", "geglu": "pallas", "sdpa": "matmul", "conv": "matmul",
              "matmul": "matmul", "norm_reduce": "reduces", "grid_sample": "other",
              "elementwise": "elementwise", "other": "other"}
# Chrome trace categories of device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_SYMBOL = re.compile(r"\b(pn_\w+)")


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


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """A ``torch.profiler`` scope (the host, and the card where there is
    one) that writes a Chrome trace, ``<pid>.<ms>.pt.trace.json``, under
    ``logdir`` at its end (view it in Perfetto or chrome://tracing; read it
    with ``trace_summary``). Nothing where ``enabled`` is False."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"))


def bucket_of(name: str) -> str:
    """The port's bucket of a kernel's name (``BUCKETS``)."""
    key = name.lower()
    return next((b for b, keys in BUCKETS if any(k in key for k in keys)), "other")


def device_summary(kernels: Iterable[Tuple[str, float]]) -> Optional[Dict]:
    """(name, ms) of each piece of device work -> ``device_ms`` (the sum),
    ``bucket_ms`` (the JAX package's buckets; copies: the names with
    "memcpy", "memset" or "copy"), ``port_bucket_ms`` (``BUCKETS``),
    ``kernel_ms`` (the port's kernels by symbol) and ``other_ms`` (the ten
    largest names in no port bucket); None where there is no device work."""
    jax_b: Dict[str, float] = defaultdict(float)
    port_b: Dict[str, float] = defaultdict(float)
    symbols: Dict[str, float] = defaultdict(float)
    other: Dict[str, float] = defaultdict(float)
    total = 0.0
    for name, ms in kernels:
        if ms <= 0:
            continue
        b = bucket_of(name)
        port_b[b] += ms
        low = name.lower()
        jax_b["copies" if any(k in low for k in ("memcpy", "memset", "copy"))
              else JAX_BUCKET[b]] += ms
        m = _SYMBOL.search(name)
        if m:
            symbols[m.group(1)] += ms
        if b == "other":
            other[name] += ms
        total += ms
    if total <= 0:
        return None

    def ordered(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))

    return {"device_ms": total, "bucket_ms": ordered(jax_b), "port_bucket_ms": ordered(port_b),
            "kernel_ms": ordered(symbols),
            "other_ms": dict(sorted(other.items(), key=lambda kv: -kv[1])[:10])}


def trace_summary(trace_dir: str) -> Optional[Dict]:
    """``device_summary`` of the newest Chrome trace under ``trace_dir``
    (``trace``'s files, searched recursively): its events of the device
    categories (kernels, copies, sets), their durations in ms. None where
    there is no trace, or the trace holds no device work (a CPU run), as
    the JAX ``hlo_stats_summary`` returns None for a bare CPU trace."""
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True),
                   key=os.path.getmtime)
    if not files:
        return None
    with open(files[-1]) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return device_summary((e.get("name", ""), float(e.get("dur", 0.0)) / 1e3)
                          for e in events if isinstance(e, dict)
                          and e.get("cat") in DEVICE_CATEGORIES)
