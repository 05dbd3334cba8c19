"""Profiling and step timing: port of mixofshow_tpu/utils/profiling.py.

The reference ships no profiling (tqdm bars only). These wrappers make a
`torch.profiler` trace and wall-clock step timing one-liners:

    with trace('/tmp/trace', device) as prof:   # chrome://tracing, Perfetto
        pipe(prompt)
    prof.key_averages()                          # device time by kernel

    timer = StepTimer(device)
    for batch in loader:
        with timer:
            trainer.train_step(state, batch, gen)
    print(timer.summary())

Both take the device explicitly: on a CUDA device the trace records the
card's activity beside the host's and the timer synchronizes that device
before it stamps a step; on the CPU there is nothing to wait for.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from mixofshow_tpu_torch.utils.device import as_device


@contextlib.contextmanager
def trace(log_dir: str, device):
    """torch.profiler over the host and, on a CUDA `device`, the card;
    writes `<log_dir>/trace.json` (a Chrome trace) when the block ends and
    yields the profile."""
    device = as_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


class StepTimer:
    """Wall-clock step timing; each step ends in a synchronization of
    `device` (a CUDA device; nothing on the CPU)."""

    def __init__(self, device):
        self.device = as_device(device)
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self, skip_warmup: int = 1) -> dict:
        """steps, and the mean, least and most seconds a step after the
        first `skip_warmup` (all steps when there are no more)."""
        ts = self.times[skip_warmup:] or self.times
        return {
            'steps': len(self.times),
            'mean_s': sum(ts) / max(len(ts), 1),
            'min_s': min(ts) if ts else 0.0,
            'max_s': max(ts) if ts else 0.0,
        }


__all__ = ['StepTimer', 'trace']
