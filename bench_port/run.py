"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights drawn on the card from the seed, the program built, one
request of the cell's shapes) is timed as `setup_s`. The window then sends
the cell's traffic for `--seconds`: requests start while less than that
has passed, and the window ends when the last one started has finished.
With `--trace 1` the same window runs untraced, then `trace_requests`
more requests run under torch.profiler and the cell's per-layer metrics
are read. Then the program is freed and the plain reference judges a
sample of the window's requests (bench_port/check.py).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and with `--trace 1`
`breakdown`), the untraced window under `window`, and last `checks`, each
compared number beside its limit (also the last lines on standard error).
Without a card, with fewer cards than the cell asks for, or with the JAX
package loaded, it prints no result and exits 1.

`--control <mode>` (one of the cell's driver's CONTROLS) puts the
cell's control in the program's place, a lower-precision path of the
program or a planted copy of the reference; the same window, sample and
check then have to read `correct` false. bench_port/readings.py runs it
over seeds to set the limits; the benchmark's own runs never pass it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mixofshow_tpu')


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of FORBIDDEN (compared
    whole: mixofshow_tpu_torch is not mixofshow_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))


def window(workload, seconds=None, count=None, first=0):
    """Closed loop, one request queued ahead: requests start while less
    than `seconds` has passed (or until `count` have started), the window
    ends when the last has finished."""
    t0 = time.perf_counter()
    i, pending, units, failed = first, None, 0, 0
    while (count is None and time.perf_counter() - t0 < seconds) or \
            (count is not None and i - first < count):
        started = workload.start(i)
        i += 1
        if pending is not None:
            n = workload.finish(pending)
            units, failed = units + n, failed + (n == 0)
        pending = started
    if pending is not None:
        n = workload.finish(pending)
        units, failed = units + n, failed + (n == 0)
    workload.wait()
    return {'requests': i - first, 'first': first, 'units': units,
            'failed': failed, 'seconds': time.perf_counter() - t0}


def run_cell(manifest, name, seed, seconds, trace, device, chips=1,
             t_start=None, control=None):
    """One run; returns the result object (the JSON line's contents)."""
    from bench_port import check, manifest as mf
    from bench_port.trace import traced

    t_start = time.perf_counter() if t_start is None else t_start
    cell = manifest.cell(name)
    cfg = manifest.config(cell)
    mix = manifest.traffic(cell)
    judge = manifest.judgement(cell)
    workload = mf.driver(mix['driver']).Workload(cfg, mix, seed, device,
                                                 control)
    workload.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start

    reset_peak(device)
    win = window(workload, seconds=seconds)
    sync(device)
    window_peak = peak(device)
    ctx = {'workload': workload, 'window': win, 'setup_s': setup_s,
           'chips': chips, 'traced': None, 'window_peak': window_peak}
    if trace:
        spans = []
        with traced(device, spans):
            ctx['trace_window'] = window(
                workload, count=mix['trace_requests'], first=win['requests'])
        ctx['traced'] = spans[0]
    memory_peak = peak(device)

    kind = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    for m in manifest.metrics(cell, kind):
        value = mf.reader(m['name'])(ctx)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    out = {'correct': None, 'attempted': win['requests'],
           'failed': win['failed'], 'metrics': metrics,
           'device': device_info(device, chips, memory_peak)}
    if trace:
        t = ctx.pop('traced')
        out['device'].update(busy_s=t.busy_s(), window_s=t.window_s)
        out['breakdown'] = {'device_ops': t.top_device_ops(),
                            'idle_gaps': t.idle_gaps()}
        del t, spans

    check.free_program(workload)
    t_check = time.perf_counter()
    done = range(win['first'], win['first'] + win['requests'])
    readings = check.worst(workload.reference_gaps(
        seed, device, done, judge['check_requests']))
    workload.close()
    checks = {k: {'value': readings[k], 'limit': judge['limits'][k]}
              for k in judge['limits']}
    out['correct'] = win['failed'] == 0 and all(
        c['value'] <= c['limit'] for c in checks.values())
    out['window'] = {'requests': win['requests'], 'units': win['units'],
                     'seconds': win['seconds'],
                     'rate': win['units'] / win['seconds'],
                     'check_s': time.perf_counter() - t_check,
                     'readings': readings}
    if trace:
        tw = ctx['trace_window']
        out['window']['traced_rate'] = tw['units'] / tw['seconds']
    out['checks'] = checks
    return out


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def reset_peak(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)


def peak(device):
    if torch.device(device).type == 'cuda':
        return torch.cuda.max_memory_allocated(device)
    return 0


def device_info(device, chips, memory_peak):
    dev = torch.device(device)
    if dev.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': chips,
                'memory_peak_bytes': memory_peak}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
            'count': chips, 'memory_peak_bytes': memory_peak}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    p.add_argument('--control', default=None)
    args = p.parse_args(argv)
    # every build and kernel cache of the program inside the checkout, at
    # a fixed path, set before the program is imported (its own nvcc
    # output goes to <root>/.torch_ext)
    os.environ['TRITON_CACHE_DIR'] = str(ROOT / '.torch_ext' / 'triton')
    os.environ['CUDA_CACHE_PATH'] = str(ROOT / '.torch_ext' / 'nv')

    from bench_port.manifest import Manifest, driver
    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    chips = cell['chips']
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f'the cell needs {chips} CUDA device(s); {seen} visible',
              file=sys.stderr)
        return 1
    controls = driver(manifest.traffic(cell)['driver']).Workload.CONTROLS
    if args.control is not None and args.control not in controls:
        print(f'--control is one of {controls}', file=sys.stderr)
        return 1
    out = run_cell(manifest, args.workload, args.seed, args.seconds,
                   args.trace, torch.device('cuda', 0), chips, T_START,
                   args.control)
    found = forbidden_modules()
    if found:
        print(f'the run loaded {found}: the benchmark measures the port '
              'alone', file=sys.stderr)
        return 1
    for k, c in out['checks'].items():
        print(f'check {k} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
