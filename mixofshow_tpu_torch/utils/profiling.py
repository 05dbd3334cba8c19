"""Profiling, spans and step timing: port of mixofshow_tpu/utils/profiling.py.

The reference ships no profiling (tqdm bars only). These wrappers make a
`torch.profiler` trace and wall-clock step timing one-liners:

    with trace('/tmp/trace', device) as prof:   # chrome://tracing, Perfetto
        pipe(prompt)
    prof.key_averages()                          # device time by kernel
    spans()                                      # the block's span records

    timer = StepTimer(device)
    for batch in loader:
        with timer:
            trainer.train_step(state, batch, gen)
    print(timer.summary())

Both take the device explicitly: on a CUDA device the trace records the
card's activity beside the host's and the timer synchronizes that device
before it stamps a step; on the CPU there is nothing to wait for.

Spans. The pipelines, the text encoder's callers, the trainer and the
loader mark their phases with `span(name, device)`: `request`, `encode`,
`adapter`, `denoise`, `unet`, `solver`, `decode`, `result`, `train.step`,
`train.forward`, `train.backward`, `train.optimizer`, `data.wait`. A span
is on only while a torch.profiler session runs on the calling thread (the
profiler's own state, `torch.autograd._profiler_enabled`); otherwise
`span` returns one shared no-op. When on, a span is

  * a `record_function('mos.<name>')` range: an event of the profiler's
    host timeline, on the clock of the card's kernels in the same trace;
  * a `SpanRecord` in memory (`spans()`, cleared by `reset()`): the name,
    the ordinal of the request (sampling call or train step) it serves,
    its parent span, host start and end in ns and, on a CUDA device, a
    pair of CUDA events on the current stream, resolved to device ms only
    when `spans()` is read (one synchronize then, none inside the window).

A `request` or `train.step` span (`root=True`) takes the next request
ordinal; a span inside it shares it; a span outside every root (the
loader's wait before a step) serves the next request. A sampling call's
result is read after the next call was queued, so `PendingSample` carries
its ordinal (`last_request()` when it was queued) to its `result` span.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mixofshow_tpu_torch.utils.device import as_device

_profiler_on = torch.autograd._profiler_enabled


@contextlib.contextmanager
def trace(log_dir: str, device):
    """torch.profiler over the host and, on a CUDA `device`, the card;
    writes `<log_dir>/trace.json` (a Chrome trace, the `mos.*` spans
    beside the kernels) when the block ends and yields the profile. The
    span records are reset on entry, so `spans()` after the block holds
    the block's."""
    device = as_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


@dataclasses.dataclass
class SpanRecord:
    """One span: `parent` is the index in `spans()` of the span it opened
    in (None at the top); `device_ms` is set on a CUDA device once
    `spans()` has resolved the event pair."""
    name: str
    request: Optional[int]
    parent: Optional[int]
    start_ns: int = 0
    end_ns: int = 0
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Off:
    """What `span` returns while no profiler runs."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Recorder:
    """The span records, the request counter and each thread's stack of
    open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.clear()

    def clear(self):
        with self.lock:
            self.records: List[SpanRecord] = []
            self.next_request = 0
            self.last_request: Optional[int] = None
            self.devices = set()

    def stack(self) -> list:
        if not hasattr(self.local, 'open'):
            self.local.open = []
        return self.local.open

    def open(self, name, request, root) -> SpanRecord:
        stack = self.stack()
        with self.lock:
            if root:
                request = self.last_request = self.next_request
                self.next_request += 1
            elif request is None:
                request = self.records[stack[-1]].request if stack else \
                    self.next_request
            rec = SpanRecord(name, request, stack[-1] if stack else None)
            self.records.append(rec)
            stack.append(len(self.records) - 1)
        return rec


_REC = _Recorder()


def span(name: str, device=None, request: Optional[int] = None,
         root: bool = False):
    """A context manager marking a phase `name` of the program (see the
    module docstring). `device`: where the phase's work runs (a CUDA
    device adds the event pair); `request`: the ordinal it serves, when it
    is not the enclosing span's; `root`: the span opens a request and
    takes the next ordinal."""
    if not _profiler_on():
        return OFF
    return _recorded(name, device, request, root)


@contextlib.contextmanager
def _recorded(name, device, request, root):
    rec = _REC.open(name, request, root)
    with record_function('mos.' + name):
        stream = None
        if device is not None and torch.device(device).type == 'cuda':
            stream = torch.cuda.current_stream(device)
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(stream)
            _REC.devices.add(stream.device)
        rec.start_ns = time.perf_counter_ns()
        try:
            yield rec
        finally:
            rec.end_ns = time.perf_counter_ns()
            if stream is not None:
                rec.events[1].record(stream)
            _REC.stack().pop()


def spans() -> List[SpanRecord]:
    """The span records since the last `reset()`, in the order the spans
    opened, each CUDA event pair resolved to `device_ms`."""
    with _REC.lock:
        devices, _REC.devices = _REC.devices, set()
        records = list(_REC.records)
    for dev in devices:
        torch.cuda.synchronize(dev)
    for rec in records:
        if rec.events is not None:
            rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
            rec.events = None
    return records


def last_request() -> Optional[int]:
    """The ordinal the last root span took (None before the first)."""
    return _REC.last_request


def reset() -> None:
    """Forget every span record and restart the request ordinals; call it
    with no span open."""
    _REC.clear()


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


__all__ = ['OFF', 'SpanRecord', 'StepTimer', 'last_request', 'reset', 'span',
           'spans', 'trace']
