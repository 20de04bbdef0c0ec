"""Finds what a cell needs by the names in BENCHMARK.json: its
configuration file, its traffic file (`traffic/<traffic>.json`), the
driver that file names (`drivers/<driver>.py`), the limits of its
correctness check (`cells/<workload>.json`) and one reader per per-layer
metric (`metrics/<metric>.py`). A later cell, traffic mix or metric is a
new file here, never an edit."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent.parent       # perfbench/
ROOT = HERE.parent                                  # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict          # the configuration file: 'config' is what runs
    traffic: dict
    limits: dict          # number compared -> limit
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / 'BENCHMARK.json') as f:
        return json.load(f)


def _reports(metric: dict, workload: str, e2e_names=None) -> bool:
    """A metric with a `workloads` list is reported in those cells; without
    one, an end-to-end metric in every cell and a per-layer metric in every
    cell that reports the metric it moves."""
    if 'workloads' in metric:
        return workload in metric['workloads']
    return e2e_names is None or metric['moves'] in e2e_names


def cell(name: str, bench: dict = None, root: Path = ROOT) -> Cell:
    bench = bench or load_benchmark(root)
    by_name = {w['name']: w for w in bench['workloads']}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; the workloads are "
                         f"{sorted(by_name)}")
    w = by_name[name]
    conf = {c['name']: c for c in bench['configs']}[w['config']]
    with open(root / conf['file']) as f:
        config = json.load(f)
    with open(HERE / 'traffic' / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / 'cells' / f"{name}.json") as f:
        limits = json.load(f)['limits']
    e2e = [m for m in bench['end_to_end'] if _reports(m, name)]
    names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if _reports(m, name, names)]
    return Cell(name, w['config'], w['traffic'], int(w['chips']), config,
                traffic, limits, e2e, per_layer)


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(traffic: dict):
    """The module `drivers/<traffic['driver']>.py`."""
    name = traffic['driver']
    return _load_file(HERE / 'drivers' / f'{name}.py',
                      f'perfbench_driver_{name}')


def reader(metric: str) -> Callable:
    """`read(tr)` of `metrics/<metric>.py`: the metric from the traced
    slice, or None where it finds nothing to read."""
    module = _load_file(HERE / 'metrics' / f'{metric}.py',
                        'perfbench_metric_' + metric.replace('.', '_'))
    return module.read


def readers(names) -> Dict[str, Callable]:
    return {n: reader(n) for n in names}
