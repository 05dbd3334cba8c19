"""BENCHMARK.json and the files it names, resolved by name.

A cell (an entry of `workloads`) names a configuration (its `file`), a
traffic mix (`bench_port/traffic/<traffic>.json`, whose `driver` names
the code that sends it, `bench_port/traffic/<driver>.py`) and has a file
of its own, `bench_port/workloads/<cell>.json`, with what the cell's
correctness check compares and its limits. Each metric is read by
`bench_port/metrics/<metric>.py`. Nothing here lists cells or metrics: a
new one is files and entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / 'BENCHMARK.json').read_text())

    def cell(self, name: str) -> dict:
        for w in self.data['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')

    def config(self, cell: dict) -> dict:
        for c in self.data['configs']:
            if c['name'] == cell['config']:
                return json.loads((self.root / c['file']).read_text())
        raise KeyError(f'no config {cell["config"]!r} in BENCHMARK.json')

    def traffic(self, cell: dict) -> dict:
        return json.loads((PKG / 'traffic' /
                           f'{cell["traffic"]}.json').read_text())

    def judgement(self, cell: dict) -> dict:
        return json.loads((PKG / 'workloads' /
                           f'{cell["name"]}.json').read_text())

    def metrics(self, cell: dict, kind: str) -> list:
        """The `end_to_end` or `per_layer` entries that apply to the
        cell."""
        return [m for m in self.data[kind]
                if 'workloads' not in m or cell['name'] in m['workloads']]


def driver(name: str):
    """The traffic driver module `bench_port/traffic/<name>.py`."""
    return importlib.import_module(f'bench_port.traffic.{name}')


def reader(metric: str):
    """`read(ctx)` of `bench_port/metrics/<metric>.py` (a metric's name may
    hold dots, so the file is loaded by its path)."""
    path = PKG / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        f'bench_port.metrics.{metric.replace(".", "__")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
