#!/usr/bin/env python3
"""Data-parallel ED-LoRA training and its sweeps on 1, 2 and 4 cards (NCCL).

    python3 tools/port_ddp_cards.py [--work DIR]

Runs the port's data-parallel path as its users launch it, `python -m
torch.distributed.run --standalone --nproc_per_node N ...` in a subprocess
(the workers are this file with `--worker`: each calls the CLI's own
`train_edlora.main(argv, on_step, report)` or `test_edlora.main(argv)` and
writes what its rank holds to `<work>/<run>/rank<r>.pt`), on N = 1, 2 and 4
CUDA cards of one host, and holds each world to the run on one card. It
needs four cards and raises with fewer: it never drops a world and never
runs on gloo or the CPU. The data is chip_smoke.py's phase-7 concept (4
seeded 640x512 images with captions and masks), the weights seeded
(random:tiny, random:sd15). Checks, in this order (each raises):

  1. fp32, random:tiny, TF32 off (utils.device.exact_fp32), the repository's
     hermione B4 config at one global batch of 4 (4, 2, 1 a card at N = 1,
     2, 4), regularizer on, 3 updates, without and with
     gradient_accumulation_steps 2 (the latter with reg_full_identity, so
     the found-subject count is reduced too): the trainables within ATOL of
     N = 1's, and every rank's trainables and optimizer state bitwise equal
     (an NCCL all-reduce gives every rank the same bits);
  2. SD1.5 width, bf16, the same config with chip_smoke.py phase 7's cuts
     (6 steps, saves every 3, validation on) at N = 2 x batch 2 against
     N = 1 x batch 4 (the same global batch), and N = 1 x 4 in fp32 (TF32
     off, validation off) beside them. Bound: the split sums in another
     order, so the two bf16 runs differ by their roundings; each is within
     d of the fp32 run, so two bf16 renditions of one computation lie within
     2d of each other (the triangle inequality). So each trainable group's
     final L2 distance from N = 1's is at most BF16_FACTOR (2) times N = 1's
     distance from fp32, and the largest per-step gap of the logged losses
     at most twice the largest bf16-to-fp32 gap. Rank 0 alone writes
     the deltas, the train states and the grids, the ranks share the PNGs,
     and the PNG names and saved files are N = 1's; ranks bitwise equal;
  3. the same config at N = 4 x batch 2 (global batch 8): it completes with
     its saves and validation (N = 1's PNG names), rank 0 alone writing,
     ranks bitwise equal;
  4. test_edlora (the repository's test config, 1 sample a prompt) on check
     2's N = 2 delta at N = 4 and at N = 1: the same files, bitwise (each
     batch is sampled whole by one rank with its own latents);
  5. numbers: at N = 1, 2, 4 with batch 2 a card (weak scaling), 12 steps,
     validation off: s/step (median and spread over steps 2-8; at N = 1
     and 4 also with the loader replaying its first batch, so that no
     loading shares the training process after the prefetch), the NCCL
     kernels' device time a step in steps 9-11 under utils.profiling.trace
     (the gradient all-reduce with its bytes, all_max's all-gathers and
     their reduce-scatter backward, the all_sums), how long the training
     thread waits on the loader a step and how long loading a global batch
     takes (A24), peak device memory a rank; the sweeps' seconds at N = 1
     and 4 (check 4); the nvcc build alone and in four ranks at once
     (check 1's first N = 1 and N = 4 launches start from no library).

Prints one line a check with the card's nvidia-smi name and power limit,
then `DDP_CARDS {json}` with every number. Each launch's output goes to
`<work>/<run>.log`; a failed launch raises with its tail.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402
from PIL import Image  # noqa: E402

from chip_smoke import (TEST_YML, VAL_SAMPLES, _same_state,  # noqa: E402
                        _write_concept, check, smi_line)
from mixofshow_tpu_torch import ops, test_edlora, train_edlora  # noqa: E402
from mixofshow_tpu_torch.models.lora import flatten_lora  # noqa: E402
from mixofshow_tpu_torch.ops import _build  # noqa: E402
from mixofshow_tpu_torch.pipelines import trainer_edlora  # noqa: E402
from mixofshow_tpu_torch.pipelines import validation  # noqa: E402
from mixofshow_tpu_torch.utils.checkpoint import train_state_dict  # noqa
from mixofshow_tpu_torch.utils.device import exact_fp32  # noqa: E402
from mixofshow_tpu_torch.utils.profiling import trace  # noqa: E402

WORLDS = (1, 2, 4)
# check 1: the data-parallel bound of tests/test_trainer.py (JAX), fp32
ATOL = 1e-5
TINY_GLOBAL_BATCH = 4
TINY_STEPS = 3
# checks 2 and 3: chip_smoke.py phase 7's cuts
SD_STEPS = 6
SD_SAVE_FREQ = 3
# check 2's bound, in units of the N = 1 bf16 run's distance from fp32
BF16_FACTOR = 2.0
# check 5: steps 2..TIME_LAST are timed, PROFILE_STEPS after them traced
TIME_STEPS = 12
TIME_LAST = 8
PROFILE_STEPS = 3
NCCL_KINDS = ('AllReduce', 'AllGather', 'ReduceScatter')
LAUNCH_TIMEOUT = 900


# ------------------------------------------------------------------ worker
def _flat_trainables(trainable):
    out = {'concept_embedding': trainable['concept_embedding']}
    for key in ('text_lora', 'unet_lora'):
        for path, leaf in flatten_lora(trainable[key] or {}).items():
            for part in ('down', 'up'):
                out[f'{key}/{path}/{part}'] = leaf[part]
    return out


def _record_writes(writes):
    """Log (function, directory/file name) of every delta, train state,
    PNG and grid this rank writes."""
    for mod, name, arg in ((train_edlora, 'save_edlora_delta', 0),
                           (train_edlora, 'save_train_state', 0),
                           (validation, 'compose_visualize', 0),
                           (validation, 'pil_imwrite', 1)):
        def logged(*a, _fn=getattr(mod, name), _name=name, _arg=arg, **kw):
            path = Path(a[_arg])
            writes.append((_name, f'{path.parent.name}/{path.name}'))
            return _fn(*a, **kw)
        setattr(mod, name, logged)


def _timed_loader(waits, loads, replay=False):
    """train_edlora's DataLoader, timing each wait of the training thread
    for a batch (`next` on `infinite()`) and each global batch's load in the
    loader thread (the dataset reads and the collate). With `replay` it
    hands out its first batch at every step, so that no loading competes
    with the training thread after the prefetch (a timing control: the
    steps compute on the same shapes)."""
    base = train_edlora.DataLoader

    class Timed:
        def __init__(self, dataset, timer):
            self.dataset, self.timer = dataset, timer

        def __len__(self):
            return len(self.dataset)

        def __getitem__(self, i):
            t0 = time.perf_counter()
            try:
                return self.dataset[i]
            finally:
                self.timer[0] += time.perf_counter() - t0

    class TimedLoader(base):
        def __init__(self, dataset, *args, collate_fn=None, **kw):
            timer = [0.0]

            def collate(items):
                t0 = time.perf_counter()
                out = collate_fn(items)
                loads.append(timer[0] + time.perf_counter() - t0)
                timer[0] = 0.0
                return out
            super().__init__(Timed(dataset, timer), *args,
                             collate_fn=collate, **kw)

        def infinite(self):
            it = super().infinite()
            first = None
            while True:
                t0 = time.perf_counter()
                batch = next(it) if first is None else first
                waits.append(time.perf_counter() - t0)
                if replay:
                    first = batch
                yield batch
    return TimedLoader


def _annotate_reduce_grads():
    """Run the trainer's gradient all-reduce inside a profiler range, so
    that the trace tells its NCCL kernel from the all_sums'."""
    fn = trainer_edlora.reduce_grads

    def annotated(*a, **kw):
        with torch.profiler.record_function('mos::reduce_grads'):
            return fn(*a, **kw)
    trainer_edlora.reduce_grads = annotated


def nccl_per_step(trace_json, steps):
    """{kind: [ms, launches] a step} of the NCCL kernels in a Chrome trace
    of `steps` train steps: 'grads' (all-reduces launched inside
    mos::reduce_grads), 'all_sum' (the other all-reduces), 'all_max'
    (all-gathers) and 'all_max_backward' (reduce-scatters: the all-gather's
    backward on NCCL, launched from the autograd thread). A kernel's kind is
    read from its name, or else from the `nccl:<op>` range (c10d's) around
    its launch."""
    events = json.loads(Path(trace_json).read_text())['traceEvents']
    launch, ranges, kernels = {}, [], []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat, args = e.get('cat', ''), e.get('args', {})
        if cat == 'kernel' and 'nccl' in e['name'].lower():
            kernels.append(e)
        elif cat in ('cuda_runtime', 'cuda_driver'):
            launch[args.get('correlation')] = (e['tid'], e['ts'])
        elif cat == 'user_annotation' and (
                e['name'] == 'mos::reduce_grads' or
                e['name'].startswith('nccl:')):
            ranges.append((e['name'], e['tid'], e['ts'], e['ts'] + e['dur']))
    names = {'all_reduce': 'AllReduce', 'all_gather': 'AllGather',
             'reduce_scatter': 'ReduceScatter'}
    out = {k: [0.0, 0] for k in ('grads', 'all_sum', 'all_max',
                                 'all_max_backward')}
    for k in kernels:
        tid, ts = launch.get(k['args'].get('correlation'), (None, -1))
        around = [n for n, t, a, b in ranges if t == tid and a <= ts <= b]
        kind = next((n for n in NCCL_KINDS if n in k['name']), None) or next(
            (v for n in around for op, v in names.items() if op in n), None)
        check(kind is not None, f'NCCL kernel {k["name"]} launched in '
              f'{around}: not an all-reduce, all-gather or reduce-scatter')
        if kind == 'AllGather':
            key = 'all_max'
        elif kind == 'ReduceScatter':
            key = 'all_max_backward'
        else:
            key = 'grads' if 'mos::reduce_grads' in around else 'all_sum'
        out[key][0] += k['dur'] / 1e3
        out[key][1] += 1
    return {k: [ms / steps, n / steps] for k, (ms, n) in out.items()}


def worker(spec):
    """One rank of a launch (under torchrun): `spec` from the parent."""
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    out = Path(spec['out'])
    if spec['fp32']:
        exact_fp32()
    torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
    t0 = time.perf_counter()
    _build.cuda_lib()
    rec = {'rank': rank, 'world': world, 'build_s': time.perf_counter() - t0,
           'writes': [], 'losses': {}, 'marks': [], 'waits': [],
           'loads': []}
    _record_writes(rec['writes'])
    argv = spec['argv'] + ['--device', 'cuda']
    if spec['cli'] == 'test':
        t0 = time.perf_counter()
        test_edlora.main(argv)
        rec['main_s'] = time.perf_counter() - t0
        rec['launches'] = ops.launch_counts()
        torch.save(rec, out / f'rank{rank}.pt')
        return
    train_edlora.DataLoader = _timed_loader(rec['waits'], rec['loads'],
                                            spec.get('replay', False))
    _annotate_reduce_grads()
    profile = spec.get('profile')
    stack = contextlib.ExitStack()

    def on_step(step, loss_dict):
        torch.cuda.synchronize()
        rec['marks'].append((step, time.perf_counter()))
        rec['losses'][step] = {k: float(v) for k, v in loss_dict.items()}
        if step == 0:
            torch.cuda.reset_peak_memory_stats()
        if profile and step == profile[0]:
            stack.enter_context(trace(str(out / f'trace{rank}'), 'cuda'))
        if profile and step == profile[1]:
            stack.close()
            path = out / f'trace{rank}' / 'trace.json'
            rec['nccl'] = nccl_per_step(path, profile[1] - profile[0])
            path.unlink()

    t0 = time.perf_counter()
    trainer, state, _ = train_edlora.main(argv, on_step=on_step)
    torch.cuda.synchronize()
    rec['main_s'] = time.perf_counter() - t0
    rec['peak_bytes'] = torch.cuda.max_memory_allocated()
    rec['launches'] = ops.launch_counts()
    rec['state'] = train_state_dict(state)
    rec['init'] = {k: v.detach().cpu() for k, v in
                   _flat_trainables(trainer.trainable_init).items()}
    rec['grad_bytes'] = 4 * sum(p.numel() for g in
                                state.optimizer.param_groups
                                for p in g['params'])
    torch.save(rec, out / f'rank{rank}.pt')


# ------------------------------------------------------------------ parent
class Runs:
    """Writes the runs' configs under `work` and launches them."""

    def __init__(self, work: Path):
        if work.exists():
            shutil.rmtree(work)
        work.mkdir(parents=True)
        self.work = work
        self.base = yaml.safe_load(_write_concept(work / 'data')
                                   .read_text())
        self.env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + os.environ.get('PYTHONPATH', '').split(
                os.pathsep)).rstrip(os.pathsep))

    def train_yml(self, name, world, per_card, steps, *, tiny=False,
                  fp32=False, accum=1, val=True, save_freq=SD_SAVE_FREQ,
                  **models):
        """The base config at `per_card` rows a card on `world` cards for
        `steps` updates (the data repeated to exactly that many)."""
        opt = yaml.safe_load(yaml.safe_dump(self.base))
        global_batch = per_card * world
        opt['datasets']['train']['batch_size_per_gpu'] = per_card
        opt['datasets']['train']['dataset_enlarge_ratio'] = \
            steps * accum * global_batch // 4
        opt['gradient_accumulation_steps'] = accum
        if tiny:
            opt['models']['pretrained_path'] = 'random:tiny'
        if tiny or fp32:
            opt['mixed_precision'] = 'no'
        opt['models'].update(models)
        opt['val']['val_during_save'] = val
        opt['path'] = {'experiments_root': str(self.work / name / 'exp')}
        opt['logger'] = {'print_freq': 1, 'save_checkpoint_freq': save_freq}
        return self._write(name, opt)

    def test_yml(self, name, delta):
        opt = yaml.safe_load(TEST_YML.read_text())
        val = opt['datasets']['val_vis']
        val['prompts'] = str(ROOT / val['prompts'])
        val['num_samples_per_prompt'] = VAL_SAMPLES
        opt['models']['pretrained_path'] = 'random:sd15'
        opt['path'] = {'lora_path': str(delta),
                       'experiments_root': str(self.work / name / 'exp')}
        return self._write(name, opt)

    def _write(self, name, opt):
        (self.work / name).mkdir()
        path = self.work / name / 'opt.yml'
        path.write_text(yaml.safe_dump(opt))
        return path

    def launch(self, name, world, cards, cli, yml, fp32=False,
               profile=None, replay=False):
        spec = {'cli': cli, 'argv': ['-opt', str(yml)], 'fp32': fp32,
                'out': str(self.work / name), 'profile': profile,
                'replay': replay}
        (self.work / name / 'spec.json').write_text(json.dumps(spec))
        argv = [sys.executable, '-m', 'torch.distributed.run',
                '--standalone', '--nproc_per_node', str(world),
                str(Path(__file__).resolve()), '--worker',
                str(self.work / name / 'spec.json')]
        env = dict(self.env, CUDA_VISIBLE_DEVICES=','.join(map(str, cards)))
        log = open(self.work / f'{name}.log', 'w')
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        return name, world, proc, log, time.perf_counter()

    def wait(self, *launches):
        """Wait for launches started together and return {name: [rank
        records]}. A rank that fails fails its launch (torchrun stops the
        others); a launch past LAUNCH_TIMEOUT is killed with its workers."""
        rcs = {}
        try:
            for name, _, proc, _, t0 in launches:
                try:
                    rcs[name] = proc.wait(timeout=max(
                        1.0, LAUNCH_TIMEOUT - (time.perf_counter() - t0)))
                except subprocess.TimeoutExpired:
                    rcs[name] = f'timeout ({LAUNCH_TIMEOUT} s)'
        finally:
            for _, _, proc, log, _ in launches:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
                log.close()
        out = {}
        for name, world, _, _, _ in launches:
            tail = (self.work / f'{name}.log').read_text()[-6000:]
            check(rcs[name] == 0, f'{name}: torchrun exited {rcs[name]}:\n'
                  f'{tail}')
            out[name] = [torch.load(self.work / name / f'rank{r}.pt',
                                    map_location='cpu', weights_only=False)
                         for r in range(world)]
        return out

    def run(self, name, world, cards, cli, yml, **kw):
        return self.wait(self.launch(name, world, cards, cli, yml, **kw))[
            name]


def _cards(world, first=0):
    return list(range(first, first + world))


def _max_diff(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a)


def _trainables(rec):
    return _flat_trainables(rec['state']['trainable'])


def _same_across_ranks(recs, what):
    for r in recs[1:]:
        _same_state(r['state'], recs[0]['state'],
                    f'{what}: rank {r["rank"]} state')


def _group_l2(a, b):
    """{group: L2 norm of a - b} over the three trainable groups."""
    out = {}
    for g in ('concept_embedding', 'text_lora', 'unet_lora'):
        keys = [k for k in a if k.split('/')[0] == g]
        out[g] = math.sqrt(sum(float(((a[k].double() - b[k].double()) ** 2)
                                     .sum()) for k in keys))
    return out


def _writes(recs, kind):
    return {r['rank']: sorted(n for f, n in r['writes'] if f == kind)
            for r in recs}


def _check_rank0_writes(recs, what):
    """Rank 0 alone writes deltas, train states and grids; the PNGs are
    written once each."""
    for kind in ('save_edlora_delta', 'save_train_state',
                 'compose_visualize'):
        got = _writes(recs, kind)
        check(all(not v for r, v in got.items() if r != 0),
              f'{what}: {kind} on ranks other than 0: {got}')
    pngs = [n for r in recs for f, n in r['writes'] if f == 'pil_imwrite']
    return pngs


def _pngs_by_rank(recs):
    return [sum(f == 'pil_imwrite' for f, _ in r['writes']) for r in recs]


def _vis_names(exp):
    return {d.name: sorted(p.name for p in d.glob('*.png'))
            for d in sorted((exp / 'visualization').iterdir()) if d.is_dir()}


def _step_times(rec, first, last):
    """Seconds of steps first..last from the on_step marks."""
    t = dict(rec['marks'])
    return [t[s] - t[s - 1] for s in range(first, last + 1)]


def check_tiny(runs, card):
    """Check 1 (and the build's cost: the first N = 1 and the N = 4
    launches start without the kernel library)."""
    # (accumulation, world, first card) launched together; the groups
    # that start an N = 1 or N = 4 run without accumulation delete the
    # library first, so that those runs time a build from nothing
    groups = [[(1, 1, 0)], [(1, 2, 0), (2, 1, 2)], [(1, 4, 0)], [(2, 2, 0)],
              [(2, 4, 0)]]
    res = {}
    for group in groups:
        if group[0][:2] in ((1, 1), (1, 4)):
            shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
        launched = []
        for accum, world, first in group:
            name = f'tiny_a{accum}_w{world}'
            extra = {'reg_full_identity': True} if accum == 2 else {}
            yml = runs.train_yml(name, world, TINY_GLOBAL_BATCH // world,
                                 TINY_STEPS, tiny=True, accum=accum,
                                 val=False, save_freq=10 ** 9, **extra)
            launched.append(runs.launch(name, world, _cards(world, first),
                                        'train', yml, fp32=True))
        for name, recs in runs.wait(*launched).items():
            accum, world = (int(x[1:]) for x in name.split('_')[1:])
            res[(accum, world)] = recs
            _same_across_ranks(recs, name)
            check(all(r['launches']['flash_fwd'] > 0 for r in recs),
                  f'{name}: a rank ran no flash kernel')
    builds = {w: [r['build_s'] for r in res[(1, w)]] for w in (1, 4)}
    rows = []
    for accum in (1, 2):
        one = _trainables(res[(accum, 1)][0])
        for world in WORLDS[1:]:
            recs = res[(accum, world)]
            diff = _max_diff(_trainables(recs[0]), one)
            loss = max(abs(recs[0]['losses'][s]['loss'] -
                           res[(accum, 1)][0]['losses'][s]['loss'])
                       for s in range(1, TINY_STEPS + 1))
            rows.append({'accum': accum, 'world': world, 'max_abs': diff,
                         'loss_max_abs': loss})
            check(diff <= ATOL, f'check 1: N = {world}, accumulation '
                  f'{accum}: trainables {diff:.3e} from N = 1\'s (bound '
                  f'{ATOL})')
    print(f'[check 1] fp32 random:tiny, TF32 off, global batch '
          f'{TINY_GLOBAL_BATCH}, {TINY_STEPS} updates, NCCL: trainables '
          f'against N = 1 ' + '; '.join(
              f'N = {r["world"]} accum {r["accum"]}: {r["max_abs"]:.3e} '
              f'(loss {r["loss_max_abs"]:.3e})' for r in rows)
          + f' (bound {ATOL}); every rank\'s trainables and optimizer '
          f'state bitwise equal at N = 2 and 4; nvcc build from no '
          f'library: one process {builds[1][0]:.2f} s, four ranks at once '
          + ', '.join(f'{b:.2f}' for b in builds[4]) + f' s; {card}',
          flush=True)
    return {'rows': rows, 'build_s': builds}


def check_sd(runs, card):
    """Checks 2 and 3."""
    y1 = runs.train_yml('sd_w1x4', 1, 4, SD_STEPS)
    y2 = runs.train_yml('sd_w2x2', 2, 2, SD_STEPS)
    yf = runs.train_yml('sd_w1x4_fp32', 1, 4, SD_STEPS, fp32=True,
                        val=False)
    got = runs.wait(runs.launch('sd_w1x4', 1, [0], 'train', y1),
                    runs.launch('sd_w2x2', 2, [1, 2], 'train', y2),
                    runs.launch('sd_w1x4_fp32', 1, [3], 'train', yf,
                                fp32=True))
    w1, w2, f1 = got['sd_w1x4'], got['sd_w2x2'], got['sd_w1x4_fp32']
    _same_across_ranks(w2, 'sd_w2x2')
    steps = range(1, SD_STEPS + 1)
    gap = {s: abs(w2[0]['losses'][s]['loss'] - w1[0]['losses'][s]['loss'])
           for s in steps}
    fgap = {s: abs(f1[0]['losses'][s]['loss'] - w1[0]['losses'][s]['loss'])
            for s in steps}
    a, b, f = (_trainables(r[0]) for r in (w2, w1, f1))
    d_dp, d_bf = _group_l2(a, b), _group_l2(f, b)
    moved = _group_l2(b, w1[0]['init'])
    check(max(gap.values()) <= BF16_FACTOR * max(fgap.values()),
          f'check 2: logged losses of N = 2 {gap} from N = 1\'s, over '
          f'{BF16_FACTOR} x the bf16 run\'s gaps to fp32 {fgap}')
    check(all(d_dp[g] <= BF16_FACTOR * d_bf[g] for g in d_dp),
          f'check 2: final trainables {d_dp} from N = 1\'s, over '
          f'{BF16_FACTOR} x bf16\'s distance from fp32 {d_bf}')
    pngs = _check_rank0_writes(w2, 'check 2')
    check(len(pngs) == len(set(pngs)), 'check 2: a PNG written twice')
    e1, e2 = (runs.work / n / 'exp' for n in ('sd_w1x4', 'sd_w2x2'))
    check(sorted(os.listdir(e1 / 'models')) ==
          sorted(os.listdir(e2 / 'models')), 'check 2: other saved files')
    check(_vis_names(e1) == _vis_names(e2), 'check 2: other PNG names')
    check(all(r['launches']['flash_fwd'] > 0 and
              r['launches']['attn_fwd'] > 0 for r in w2),
          'check 2: a rank ran no flash or validation kernel')
    n_png = sum(len(v) for v in _vis_names(e1).values())
    print(f'[check 2] SD1.5 bf16, {SD_STEPS} steps, saves every '
          f'{SD_SAVE_FREQ} with validation, N = 2 x 2 against N = 1 x 4: '
          f'logged losses |Δ| ' + ', '.join(f'{gap[s]:.3e}' for s in steps)
          + f' (bound {BF16_FACTOR} x the largest bf16-vs-fp32 gap of '
          + ', '.join(f'{fgap[s]:.3e}' for s in steps) + '); final L2 by '
          f'group {_fmt(d_dp)} (bound {BF16_FACTOR} x bf16-vs-fp32 '
          f'{_fmt(d_bf)}; N = 2 from fp32 {_fmt(_group_l2(a, f))}; moved by '
          f'training {_fmt(moved)}); largest entry '
          f'{_max_diff(a, b):.3e}; ranks bitwise equal; rank 0 alone wrote '
          f'{_writes(w2, "save_edlora_delta")[0]}, the train states and '
          f'{len(_writes(w2, "compose_visualize")[0])} grids; PNGs by '
          f'rank {_pngs_by_rank(w2)}'
          f' ({n_png} names, N = 1\'s); runs {w1[0]["main_s"]:.2f} s '
          f'(N = 1), {w2[0]["main_s"]:.2f} s (N = 2), fp32 '
          f'{f1[0]["main_s"]:.2f} s; {card}', flush=True)

    y4 = runs.train_yml('sd_w4x2', 4, 2, SD_STEPS)
    w4 = runs.run('sd_w4x2', 4, _cards(4), 'train', y4)
    _same_across_ranks(w4, 'sd_w4x2')
    pngs = _check_rank0_writes(w4, 'check 3')
    e4 = runs.work / 'sd_w4x2' / 'exp'
    check(len(pngs) == len(set(pngs)) == n_png and
          _vis_names(e4) == _vis_names(e1), 'check 3: other PNGs')
    check(sorted(os.listdir(e4 / 'models')) ==
          sorted(os.listdir(e1 / 'models')), 'check 3: other saved files')
    check(all(r['launches']['flash_fwd'] > 0 for r in w4),
          'check 3: a rank ran no flash kernel')
    losses = [round(w4[0]['losses'][s]['loss'], 5) for s in steps]
    print(f'[check 3] SD1.5 bf16 N = 4 x 2 (global batch 8): {SD_STEPS} '
          f'steps with saves {sorted(os.listdir(e4 / "models"))} and '
          f'{n_png} validation PNGs (rank 0 alone saving and composing; '
          f'PNGs by rank {_pngs_by_rank(w4)}'
          f'), losses {losses}, ranks bitwise equal; '
          f'{w4[0]["main_s"]:.2f} s; peak memory by rank '
          f'{[round(r["peak_bytes"] / 2 ** 30, 2) for r in w4]} GiB; {card}',
          flush=True)
    return {'loss_gap': gap, 'fp32_loss_gap': fgap, 'l2': d_dp,
            'l2_bound': d_bf, 'moved': moved,
            'run_s': {'w1x4': w1[0]['main_s'], 'w2x2': w2[0]['main_s'],
                      'w4x2': w4[0]['main_s']},
            'peak_gib': {n: [r['peak_bytes'] / 2 ** 30 for r in rs]
                         for n, rs in (('w1x4', w1), ('w2x2', w2),
                                       ('w4x2', w4))}}


def _fmt(d):
    return '{' + ', '.join(f'{k}: {v:.3e}' for k, v in d.items()) + '}'


def check_sweep(runs, card):
    """Check 4."""
    delta = runs.work / 'sd_w2x2' / 'exp' / 'models' / \
        'edlora_model-latest.pth'
    recs = {}
    for world in (1, 4):
        name = f'sweep_w{world}'
        recs[world] = runs.run(name, world, _cards(world), 'test',
                               runs.test_yml(name, delta))
    files = {w: {str(p.relative_to(runs.work / f'sweep_w{w}' / 'exp')):
                 p.read_bytes() for p in sorted(
                     (runs.work / f'sweep_w{w}' / 'exp' / 'visualization')
                     .rglob('*')) if p.is_file()} for w in (1, 4)}
    check(sorted(files[1]) == sorted(files[4]) and files[1],
          f'check 4: N = 4 wrote {sorted(files[4])[:4]}..., N = 1 '
          f'{sorted(files[1])[:4]}...')
    worst = 0
    for n in files[1]:
        if files[1][n] != files[4][n] and n.endswith('.png'):
            a, b = (np.asarray(Image.open(runs.work / f'sweep_w{w}' / 'exp' /
                                          n)).astype(int) for w in (1, 4))
            worst = max(worst, int(np.abs(a - b).max()))
    same = [n for n in files[1] if files[1][n] == files[4][n]]
    check(len(same) == len(files[1]), f'check 4: {len(files[1]) - len(same)} '
          f'of {len(files[1])} files differ, PNGs by up to {worst} uint8 '
          f'levels')
    _check_rank0_writes(recs[4], 'check 4')
    secs = {w: max(r['main_s'] for r in recs[w]) for w in (1, 4)}
    print(f'[check 4] test_edlora on check 2\'s N = 2 delta: N = 4 wrote '
          f'N = 1\'s {len(files[1])} files bitwise; PNGs by rank '
          f'{_pngs_by_rank(recs[4])}; '
          f'sweep (test_edlora.main, model load included) {secs[1]:.2f} s '
          f'at N = 1, {secs[4]:.2f} s at N = 4; {card}', flush=True)
    return {'sweep_s': secs}


def check_numbers(runs, card):
    """Check 5: weak scaling at batch 2 a card."""
    out = {}
    for world in WORLDS:
        name = f'time_w{world}'
        yml = runs.train_yml(name, world, 2, TIME_STEPS, val=False,
                             save_freq=10 ** 9)
        recs = runs.run(name, world, _cards(world), 'train', yml,
                        profile=[TIME_LAST, TIME_LAST + PROFILE_STEPS])
        r0 = recs[0]
        steps = _step_times(r0, 2, TIME_LAST)
        waits = r0['waits']
        nccl = r0['nccl']
        out[world] = {
            'step_s_median': statistics.median(steps),
            'step_s_min': min(steps), 'step_s_max': max(steps),
            'wait_s': waits, 'wait_s_median': statistics.median(
                waits[1:TIME_LAST]),
            'wait_s_first': waits[0],
            'load_s_median': statistics.median(r0['loads']),
            'load_s_max': max(r0['loads']),
            'nccl_ms': {k: v[0] for k, v in nccl.items()},
            'nccl_launches': {k: v[1] for k, v in nccl.items()},
            'nccl_ms_by_rank': [{k: v[0] for k, v in r['nccl'].items()}
                                for r in recs],
            'grad_bytes': r0['grad_bytes'],
            'peak_gib': [r['peak_bytes'] / 2 ** 30 for r in recs]}
        if world > 1:
            check(nccl['grads'][1] == 1,
                  f'check 5: N = {world}: {nccl} (one gradient all-reduce '
                  f'a step expected)')
        o = out[world]
        print(f'[check 5] N = {world} x 2 (global {2 * world}), SD1.5 bf16, '
              f'validation off: {o["step_s_median"]:.4f} s/step median over '
              f'steps 2-{TIME_LAST} (min {o["step_s_min"]:.4f}, max '
              f'{o["step_s_max"]:.4f}); NCCL a step (steps '
              f'{TIME_LAST + 1}-{TIME_LAST + PROFILE_STEPS}, rank 0) '
              f'{_fmt(o["nccl_ms"])} ms, launches {o["nccl_launches"]}, '
              f'gradient all-reduce {o["grad_bytes"]} bytes; loader wait a '
              f'step median {o["wait_s_median"] * 1e3:.3f} ms (first step '
              f'{o["wait_s_first"] * 1e3:.1f} ms), a global batch\'s load '
              f'median {o["load_s_median"] * 1e3:.1f} ms (max '
              f'{o["load_s_max"] * 1e3:.1f}); peak memory by rank '
              f'{[round(p, 2) for p in o["peak_gib"]]} GiB; {card}',
              flush=True)
    # the same runs with the loader replaying its first batch: no load
    # work in the training processes after the prefetch
    for world in (1, WORLDS[-1]):
        name = f'replay_w{world}'
        yml = runs.train_yml(name, world, 2, TIME_STEPS, val=False,
                             save_freq=10 ** 9)
        steps = _step_times(runs.run(name, world, _cards(world), 'train',
                                     yml, replay=True)[0], 2, TIME_LAST)
        out[world]['replay_step_s'] = steps
        print(f'[check 5] N = {world} x 2 with the loader replaying its '
              f'first batch (no loading after the prefetch): '
              f'{statistics.median(steps):.4f} s/step median over steps '
              f'2-{TIME_LAST} (min {min(steps):.4f}, max {max(steps):.4f}), '
              f'against {out[world]["step_s_median"]:.4f} loading; {card}',
              flush=True)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--work', default=str(ROOT / 'experiments' /
                                              'ddp_cards'))
    parser.add_argument('--worker', default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        worker(json.loads(Path(args.worker).read_text()))
        return
    check(torch.cuda.is_available(), 'no CUDA device is visible')
    n = torch.cuda.device_count()
    check(n >= max(WORLDS), f'{n} CUDA card(s) visible; the checks need '
          f'{max(WORLDS)} (worlds {WORLDS})')
    card = smi_line()
    nccl = torch.cuda.nccl.version()
    nccl = '.'.join(map(str, nccl)) if isinstance(nccl, tuple) else nccl
    print(f'[device] {n} x {torch.cuda.get_device_name(0)} | nvidia-smi: '
          f'{card} | torch {torch.__version__} CUDA {torch.version.cuda} '
          f'NCCL {nccl}', flush=True)
    runs = Runs(Path(args.work))
    t0 = time.perf_counter()
    result = {'card': card, 'tiny': check_tiny(runs, card)}
    result['sd'] = check_sd(runs, card)
    result['sweep'] = check_sweep(runs, card)
    result['numbers'] = check_numbers(runs, card)
    result['total_s'] = time.perf_counter() - t0
    print('DDP_CARDS ' + json.dumps(result, default=str))
    print(card)


if __name__ == '__main__':
    main()
