"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from bench_port import manifest as mf
from bench_port.run import FORBIDDEN, forbidden_modules

M = mf.Manifest()
B = M.data
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in B['workloads']]
# keys that name a width, which a configuration may never cut
WIDTHS = re.compile(r'(_dim|_rank|channels|width|heads|hidden|'
                    r'intermediate|mlp|latent|projection)')


def test_top_level_keys_and_command():
    assert set(B) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= len(B['command']) <= 32
    for word in B['command']:
        assert not word.startswith('/') and '..' not in word
    assert B['command'][1].startswith(B['paths'][0] + '/')
    assert all(re.fullmatch(r'[A-Za-z0-9_./-]{1,200}', p) for p in B['paths'])
    assert len(json.dumps(B)) <= 64 * 1024


def test_run_seconds_fits_a_full_check():
    r = B['run_seconds']
    assert 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize('kind', ['configs', 'workloads', 'end_to_end',
                                  'per_layer'])
def test_names_and_units(kind):
    names = [e['name'] for e in B[kind]]
    assert len(names) == len(set(names))
    for e in B[kind]:
        assert NAME.match(e['name']), e['name']
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
        for text in (e.get('why'), e.get('layer'), e.get('source')):
            if text is not None:
                assert 1 <= len(text) <= 200 and '\n' not in text


@pytest.mark.parametrize('cell', CELLS)
def test_cell_resolves_its_files(cell):
    w = M.cell(cell)
    assert w['chips'] in (1, 4)
    cfg = M.config(w)
    mix = M.traffic(w)
    judge = M.judgement(w)
    driver = mf.driver(mix['driver'])
    assert hasattr(driver, 'Workload')
    assert judge['limits'] and judge['check_requests'] >= 0
    assert judge['controls'] and \
        set(judge['controls']) <= set(driver.Workload.CONTROLS)
    for kind in ('end_to_end', 'per_layer'):
        for m in M.metrics(w, kind):
            assert callable(mf.reader(m['name']))
    assert cfg['name'] == w['config']


@pytest.mark.parametrize('entry', B['configs'], ids=lambda c: c['name'])
def test_config_files(entry):
    path = M.root / entry['file']
    assert path.is_file() and entry['file'].startswith(B['paths'][0] + '/')
    cfg = json.loads(path.read_text())
    assert cfg['reduced'] == entry['reduced']
    assert not any(WIDTHS.search(k) for k in entry['reduced'])
    assert entry['source'].startswith('https://')
    assert sum(c['file'] == entry['file'] for c in B['configs']) == 1
    assert any(w['config'] == entry['name'] for w in B['workloads'])


def test_end_to_end_metrics():
    names = {m['name'] for m in B['end_to_end']}
    assert 'setup_s' in names and 1 <= len(names) <= 16
    for m in B['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for cell in CELLS:
        got = {m['name'] for m in M.metrics(M.cell(cell), 'end_to_end')}
        assert 'setup_s' in got and len(got) >= 2


@pytest.mark.parametrize('metric', B['per_layer'], ids=lambda m: m['name'])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    assert metric['source'] in ('device_trace', 'program_span',
                                'program_counter', 'host_clock')
    assert 'bound' not in metric
    e2e = {m['name']: m for m in B['end_to_end']}
    assert metric['moves'] in e2e
    for cell in metric['workloads']:
        assert cell in CELLS
        reported = {m['name'] for m in M.metrics(M.cell(cell),
                                                 'end_to_end')}
        assert metric['moves'] in reported
    layers = {m['layer'] for m in B['per_layer']}
    assert all(len(layer) <= 200 for layer in layers)


def test_every_cell_has_a_per_layer_metric():
    for cell in CELLS:
        assert M.metrics(M.cell(cell), 'per_layer')


def test_forbidden_names_compare_whole_top_level_names():
    assert forbidden_modules({'mixofshow_tpu_torch': 0,
                              'mixofshow_tpu_torch.ops': 0,
                              'jaxtyping': 0, 'numpy': 0}) == []
    assert forbidden_modules({'jax.numpy': 0, 'mixofshow_tpu.ops': 0,
                              'flax': 0}) == ['flax', 'jax',
                                              'mixofshow_tpu']
    assert set(FORBIDDEN) == {'jax', 'jaxlib', 'flax', 'mixofshow_tpu'}


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole tiny run of every cell in a fresh interpreter, then the
    check the harness makes before it prints."""
    code = (
        'import sys, torch\n'
        'torch.set_num_threads(2)\n'
        'from bench_port.tests.tiny import TinyManifest\n'
        'from bench_port import run\n'
        f'm = TinyManifest({str(tmp_path)!r}, steps=1)\n'
        'for cell in [w["name"] for w in m.data["workloads"]]:\n'
        '    run.run_cell(m, cell, 5, 0.1, 1, torch.device("cpu"))\n'
        'print(run.forbidden_modules())\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=mf.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_run_without_a_card_prints_nothing_and_fails():
    out = subprocess.run(
        [sys.executable, 'bench_port/run.py', '--workload', CELLS[0],
         '--seed', str(2 ** 31 + 7), '--seconds', '1', '--trace', '0'],
        cwd=mf.ROOT, capture_output=True, text=True, timeout=300,
        env={'CUDA_VISIBLE_DEVICES': '', 'PATH': '/usr/bin:/bin'})
    assert out.returncode != 0 and out.stdout == ''
