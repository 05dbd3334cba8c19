"""Per-layer metrics read from the program's own spans in a traced run.

The port marks its phases with `mixofshow_tpu_torch.utils.profiling.span`
(`request`, `encode`, `adapter`, `denoise`, `unet`, `solver`, `decode`,
`result`, `train.step`, `train.forward`, `train.backward`,
`train.optimizer`, `data.wait`). While a profiler runs, each span is kept
as a record (`profiling.spans()`: host ns and, on the card, the device ms
of a CUDA event pair) and is a `mos.<name>` range of the profiler's host
timeline, which `bench_port/trace.Traced` holds among its host operations
on the device trace's clock.

Host and device milliseconds come from the records; whatever is set
against the device trace (launches inside a span, idle gaps by span) from
the `mos.*` host operations. A "per request" number is divided by the
traced requests (`ctx['trace_window']['requests']`). A program without
spans gives nothing to read: every reader then returns None, as the device
ms readers do on the CPU.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

PREFIX = 'mos.'
LAUNCHES = ('cudaLaunchKernel', 'cuLaunchKernel', 'cudaLaunchKernelExC')


def records(ctx):
    """The span records of the traced window: `ctx['spans']` where a caller
    set it, else the program's `profiling.spans()` (kept there). None where
    the program keeps no span records."""
    if 'spans' not in ctx:
        from mixofshow_tpu_torch.utils import profiling
        read = getattr(profiling, 'spans', None)
        ctx['spans'] = None if read is None else read()
    return ctx['spans']


def _named(ctx, name):
    return [r for r in records(ctx) or () if r.name == name]


def _per_request(ctx, total):
    tw = ctx.get('trace_window')
    return total / tw['requests'] if tw and tw['requests'] else None


def mean_host_ms(name):
    """A reader of the mean host ms of a `name` span."""
    def read(ctx):
        rs = _named(ctx, name)
        return sum(r.host_ms for r in rs) / len(rs) if rs else None
    return read


def host_ms_per_request(name):
    """A reader of the host ms of `name` spans a traced request."""
    def read(ctx):
        rs = _named(ctx, name)
        return _per_request(ctx, sum(r.host_ms for r in rs)) if rs else None
    return read


def _device_ms(ctx, name):
    rs = _named(ctx, name)
    if not rs or any(r.device_ms is None for r in rs):
        return None
    return [r.device_ms for r in rs]


def mean_device_ms(name):
    """A reader of the mean device ms of a `name` span (its CUDA event
    pair); None on the CPU."""
    def read(ctx):
        ms = _device_ms(ctx, name)
        return sum(ms) / len(ms) if ms else None
    return read


def device_ms_per_request(name):
    """A reader of the device ms of `name` spans a traced request; None on
    the CPU."""
    def read(ctx):
        ms = _device_ms(ctx, name)
        return _per_request(ctx, sum(ms)) if ms else None
    return read


def launches_per(name):
    """A reader of the kernel-launch runtime events (`LAUNCHES`) that start
    inside a `mos.<name>` range of the trace, a range."""
    def read(ctx):
        t = ctx.get('traced')
        if t is None:
            return None
        ranges = [(s, e) for s, e, n in t.host_ops if n == PREFIX + name]
        if not ranges:
            return None
        starts = sorted(s for s, _, n in t.host_ops if n in LAUNCHES)
        count = sum(bisect.bisect_left(starts, e) -
                    bisect.bisect_left(starts, s) for s, e in ranges)
        return count / len(ranges)
    return read


def _gaps(traced):
    """[(start ns, length ns)] of the window's idle device time: the gaps
    between the union of its device operations."""
    gaps, prev = [], traced.lo
    for s, e, _ in sorted(traced.device_ops):
        s, e = max(s, traced.lo), min(e, traced.hi)
        if e <= s:
            continue
        if s > prev:
            gaps.append((prev, s - prev))
        prev = max(prev, e)
    if traced.hi > prev:
        gaps.append((prev, traced.hi - prev))
    return gaps


def idle_by_span(traced):
    """Idle device ns of the window by the innermost `mos.*` range open on
    the host where each gap begins (the latest-started range that holds
    the gap's start, over all the ranges), None for gaps outside every
    one."""
    ranges = sorted((s, e, n) for s, e, n in traced.host_ops
                    if n.startswith(PREFIX))
    by, stack, i = defaultdict(int), [], 0
    for start, length in _gaps(traced):
        while i < len(ranges) and ranges[i][0] <= start:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] <= start:
            stack.pop()
        by[stack[-1][2] if stack else None] += length
    return by


def idle_share_in(name):
    """A reader of the share (%) of the traced window's idle device time
    whose gaps begin inside a `mos.<name>` range, innermost."""
    def read(ctx):
        t = ctx.get('traced')
        if t is None or not any(n.startswith(PREFIX)
                                for _, _, n in t.host_ops):
            return None
        by = idle_by_span(t)
        total = sum(by.values())
        return 100.0 * by[PREFIX + name] / total if total else None
    return read


unet_host_ms = mean_host_ms('unet')
launches_per_unet = launches_per('unet')
text_host_ms = host_ms_per_request('encode')
result_wait_ms = host_ms_per_request('result')
idle_in_unet_pct = idle_share_in('unet')
unet_device_ms = mean_device_ms('unet')
decode_device_ms = device_ms_per_request('decode')
forward_host_ms = host_ms_per_request('train.forward')
backward_host_ms = host_ms_per_request('train.backward')
optimizer_host_ms = host_ms_per_request('train.optimizer')
data_wait_ms = host_ms_per_request('data.wait')
