"""Readings that a cell's correctness limits are set from: run.run_cell
over seeds, once as the benchmark runs it (mode 'none') and once with
each control in the program's place (run.py's `--control`), each a short
window of the cell's own size and load, in one process.

    python3 bench_port/readings.py --workload <cell> --seeds 11,12,... \
        [--controls int8,int8+conv] [--control-seeds 11,12,13] \
        [--seconds 1] [--out <file.jsonl>]

`--controls` defaults to the ones the cell's file holds to its limits
(bench_port/workloads/<cell>.json), `--control-seeds` to the first three.

One JSON line a run: {"seed", "mode", "correct", "readings", "setup_s",
"check_s"}; then one line a mode with each number's least and largest
reading over its seeds (the lower reading of a limit is the largest of
'none', the upper the least of a control). Needs a CUDA device.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_port import manifest as mf, run  # noqa: E402


def emit(line, out):
    print(json.dumps(line), flush=True)
    if out:
        with open(out, 'a') as f:
            f.write(json.dumps(line) + '\n')


def readings(name, seeds, controls, control_seeds, seconds, device, out):
    m = mf.Manifest(ROOT)
    if controls is None:
        controls = m.judgement(m.cell(name))['controls']
    got = {}
    for mode, mode_seeds in [('none', seeds)] + [(c, control_seeds)
                                                 for c in controls]:
        for seed in mode_seeds:
            r = run.run_cell(m, name, seed, seconds, 0, device,
                             control=None if mode == 'none' else mode)
            got.setdefault(mode, []).append(r['window']['readings'])
            emit({'seed': seed, 'mode': mode, 'correct': r['correct'],
                  'readings': r['window']['readings'],
                  'setup_s': r['metrics']['setup_s']['value'],
                  'check_s': r['window']['check_s']}, out)
    for mode, rs in got.items():
        emit({'mode': mode, 'seeds': len(rs),
              'range': {k: [min(x[k] for x in rs), max(x[k] for x in rs)]
                        for k in rs[0]}}, out)
    return got


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--controls', default=None)
    p.add_argument('--control-seeds', default=None)
    p.add_argument('--seconds', type=float, default=1.0)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('readings need a CUDA device', file=sys.stderr)
        return 1
    seeds = [int(s) for s in args.seeds.split(',')]
    control_seeds = seeds[:3] if args.control_seeds is None else [
        int(s) for s in args.control_seeds.split(',')]
    controls = None if args.controls is None else [
        c for c in args.controls.split(',') if c]
    readings(args.workload, seeds, controls, control_seeds, args.seconds,
             torch.device('cuda', 0), args.out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
