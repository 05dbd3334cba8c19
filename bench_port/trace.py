"""A profiled stretch of a run, reduced to what the per-layer metrics read.

`Traced` holds, from one `torch.profiler` window over the host and the
card: every device operation (kernel, copy, set) as (start, end, name) in
nanoseconds, the host operations and the benchmark's own spans, and the
window's bounds (the `bench.window` span). From them: busy seconds (the
union of device intervals inside the window), device time by kernel name,
and the idle gaps labelled by the innermost host operation running when
each began.
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = 'bench.window'


class Traced:
    def __init__(self, device_ops, host_ops, window_ns):
        self.device_ops = device_ops      # [(start, end, name)], sorted
        self.host_ops = host_ops          # [(start, end, name)], sorted
        self.lo, self.hi = window_ns

    @property
    def window_s(self):
        return (self.hi - self.lo) / 1e9

    def _union(self):
        out = []
        for s, e, _ in self.device_ops:
            s, e = max(s, self.lo), min(e, self.hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self._union()) / 1e9

    def device_s(self, fragments=None):
        """Seconds of device operations whose name holds one of
        `fragments` (all operations without)."""
        return sum(e - s for s, e, n in self.device_ops
                   if fragments is None or any(f in n for f in fragments)
                   ) / 1e9

    def top_device_ops(self, k=10):
        by = defaultdict(int)
        for s, e, n in self.device_ops:
            by[n] += e - s
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k=10):
        """Idle device time inside the window, summed by the innermost host
        operation running where each gap began."""
        starts = [s for s, _, _ in self.host_ops]
        by = defaultdict(int)
        prev = self.lo
        for s, e in self._union() + [[self.hi, self.hi]]:
            if s > prev:
                by[self._host_at(prev, starts)] += s - prev
            prev = max(prev, e)
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda x: -x[1])[:k]]

    def _host_at(self, t, starts, look_back=64):
        """The latest-started host operation still running at t, among the
        `look_back` that started last before it."""
        i = bisect.bisect_right(starts, t)
        for s, e, n in reversed(self.host_ops[max(0, i - look_back):i]):
            if t < e:
                return n
        return 'no host operation'


DEVICE_KINDS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _events(prof):
    """(device ops, host ops) from the profiler's kineto events. The device
    side of a record_function range is no operation: it is left out by its
    activity type where the profiler gives one, else by its name, which a
    host event also has (a kernel's never does)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        kind = getattr(e, 'activity_type', None)
        row = (s, s + e.duration_ns(), e.name(), kind() if kind else None)
        if e.device_type() == DeviceType.CUDA:
            dev.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row[:3])
    names = {n for _, _, n in host}
    dev = [r[:3] for r in dev if r[3] in DEVICE_KINDS or
           (r[3] is None and r[2] not in names)]
    dev.sort()
    host.sort()
    return dev, host


@contextlib.contextmanager
def traced(device, out: list):
    """Profile the block as one window; appends a `Traced` to `out`."""
    cuda = torch.device(device).type == 'cuda'
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield
            if cuda:
                torch.cuda.synchronize(device)
    dev, host = _events(prof)
    span = [(s, e) for s, e, n in host if n == WINDOW]
    if not span:
        raise RuntimeError('the profile holds no window span')
    out.append(Traced(dev, [h for h in host if h[2] != WINDOW], span[0]))
