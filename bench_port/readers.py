"""What the metric files of bench_port/metrics/ read, from a run's context:
`window` (the untraced window: requests, units, seconds), `setup_s`,
`window_peak` (bytes allocated at most during the window), `chips`,
`workload` (its model FLOPs and kernel work a request) and, in a traced
run, `traced` (bench_port/trace.Traced) and `trace_window`. A reader that
finds nothing to read returns None and the metric is left out.
"""
from __future__ import annotations

import json
from pathlib import Path

from bench_port import flops

KERNELS = Path(__file__).resolve().parent / 'kernels'


def units_per_s(ctx):
    w = ctx['window']
    return w['units'] / w['seconds'] if w['seconds'] > 0 else None


def setup_s(ctx):
    return ctx['setup_s']


def idle_pct(ctx):
    """Share of the untraced window in which no device operation ran: the
    traced requests' busy device seconds (the union of their kernels,
    copies and sets) a request, over the untraced window's seconds a
    request. The profiler slows the host, so in a host-bound cell the
    traced window itself is idle for longer than a run is."""
    t, w, tw = ctx['traced'], ctx['window'], ctx.get('trace_window')
    if t is None or not tw or not tw['requests'] or not w['requests']:
        return None
    busy = t.busy_s() / tw['requests']
    return 100.0 * (1.0 - busy / (w['seconds'] / w['requests']))


def window_peak_gib(ctx):
    return ctx['window_peak'] / 2 ** 30 if ctx['window_peak'] else None


def mfu(ctx):
    """Model FLOPs of the requests the untraced window finished, over its
    seconds at the chips' bf16 peak."""
    w = ctx['window']
    done = w['requests'] - w['failed']
    if w['seconds'] <= 0 or not done:
        return None
    work = done * ctx['workload'].model_flops()
    return 100.0 * work / (w['seconds'] * flops.PEAK_FLOPS * ctx['chips'])


def kernel_roofline(listing: str):
    """A reader of the least time of the listed kernels' work in the traced
    requests over those kernels' device time, in %."""
    spec = json.loads((KERNELS / f'{listing}.json').read_text())

    def read(ctx):
        t = ctx['traced']
        if t is None:
            return None
        device_s = t.device_s(spec['kernels'])
        work = getattr(ctx['workload'], spec['work'])()
        if device_s <= 0 or not work:
            return None
        least = ctx['trace_window']['requests'] * sum(
            flops.least_s(f, b) for f, b in work)
        return 100.0 * least / device_s
    return read


def seconds_per_request(ctx):
    w = ctx['window']
    return w['seconds'] / w['requests'] if w['requests'] else None


def loader_wait_ms(ctx):
    """Host milliseconds a step of the untraced window waited on the
    loader's `next`."""
    w = ctx['window']
    waits = [ctx['workload'].waits.get(i, 0.0)
             for i in range(w['first'], w['first'] + w['requests'])]
    return 1e3 * sum(waits) / len(waits) if waits else None
