"""LR schedules (counterpart of ``panacea_tpu/utils/lr_schedule.py``;
reference sgm/lr_scheduler.py:4-135): step -> multiplier callables, which
``utils.optim.AdamW`` takes as its ``lr_schedule``."""

from __future__ import annotations

import numpy as np


class LambdaWarmUpCosineScheduler:
    """Linear warmup then cosine decay to lr_min (lr_scheduler.py:4-36)."""

    def __init__(self, warm_up_steps, lr_min, lr_max, lr_start, max_decay_steps,
                 verbosity_interval=0):
        self.lr_warm_up_steps = warm_up_steps
        self.lr_start = lr_start
        self.lr_min = lr_min
        self.lr_max = lr_max
        self.lr_max_decay_steps = max_decay_steps

    def schedule(self, n):
        if n < self.lr_warm_up_steps:
            return (self.lr_max - self.lr_start) / self.lr_warm_up_steps * n + self.lr_start
        t = (n - self.lr_warm_up_steps) / (self.lr_max_decay_steps - self.lr_warm_up_steps)
        t = min(t, 1.0)
        return self.lr_min + 0.5 * (self.lr_max - self.lr_min) * (1 + np.cos(t * np.pi))

    def __call__(self, n):
        return self.schedule(n)


class LambdaWarmUpCosineScheduler2:
    """Multi-cycle variant with per-cycle settings (lr_scheduler.py:39-104)."""

    def __init__(self, warm_up_steps, f_min, f_max, f_start, cycle_lengths,
                 verbosity_interval=0):
        if not (len(warm_up_steps) == len(f_min) == len(f_max) == len(f_start)
                == len(cycle_lengths)):
            raise ValueError("every per-cycle setting needs one entry per cycle")
        self.lr_warm_up_steps = warm_up_steps
        self.f_start = f_start
        self.f_min = f_min
        self.f_max = f_max
        self.cycle_lengths = cycle_lengths
        self.cum_cycles = np.cumsum([0] + list(cycle_lengths))

    def find_in_interval(self, n):
        interval = 0
        for cl in self.cum_cycles[1:]:
            if n <= cl:
                return interval
            interval += 1
        return interval

    def schedule(self, n):
        cycle = min(self.find_in_interval(n), len(self.cycle_lengths) - 1)
        n = n - self.cum_cycles[cycle]
        if n < self.lr_warm_up_steps[cycle]:
            return (self.f_max[cycle] - self.f_start[cycle]) / self.lr_warm_up_steps[cycle] * n \
                + self.f_start[cycle]
        t = (n - self.lr_warm_up_steps[cycle]) / (
            self.cycle_lengths[cycle] - self.lr_warm_up_steps[cycle])
        t = min(t, 1.0)
        return self.f_min[cycle] + 0.5 * (self.f_max[cycle] - self.f_min[cycle]) * (
            1 + np.cos(t * np.pi))

    def __call__(self, n):
        return self.schedule(n)


class LambdaLinearScheduler(LambdaWarmUpCosineScheduler2):
    """Linear decay cycles (lr_scheduler.py:107-135)."""

    def schedule(self, n):
        cycle = min(self.find_in_interval(n), len(self.cycle_lengths) - 1)
        n = n - self.cum_cycles[cycle]
        if n < self.lr_warm_up_steps[cycle]:
            return (self.f_max[cycle] - self.f_start[cycle]) / self.lr_warm_up_steps[cycle] * n \
                + self.f_start[cycle]
        return self.f_min[cycle] + (self.f_max[cycle] - self.f_min[cycle]) * (
            self.cycle_lengths[cycle] - n) / self.cycle_lengths[cycle]
