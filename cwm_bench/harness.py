"""The benchmark's machinery, driven by the files under ``cwm_bench/``.

A cell is found by its name: its entry in ``BENCHMARK.json`` (chips, the
metrics it reports), its file ``workloads/<cell>.json`` (configuration,
driver, traffic, limits of the output check) and the configuration's file
``configs/<config>.json``. The driver ``drivers/<driver>.py`` defines
``Run(config, traffic, seed, device)`` with ``warmup()``, ``window(seconds)
-> Window``, ``stage_spans()``, ``profiled_unit()``, ``profile_units`` and
``check()``. Each per-layer metric is read by ``metrics/<metric>.py``,
whose ``read(ctx)`` returns a number or None (nothing to read). A later
cell, traffic kind or metric is new files and new entries only.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(ROOT, '.cwm_bench_cache')

# compared by the top-level module name whole: the port's own name,
# counterfactualworldmodels_tpu_torch, starts with the JAX package's
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'counterfactualworldmodels_tpu')


def forbidden_modules(modules) -> List[str]:
    """The forbidden top-level names among the loaded ``modules``."""
    tops = {name.split('.')[0] for name in modules}
    return sorted(tops.intersection(FORBIDDEN))


def set_cache_env() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, and keep libraries from loading JAX on their own."""
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton'),
                     ('CUDA_CACHE_PATH', 'cuda')):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def _load_json(*parts) -> Any:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict[str, Any]      # the cell's entry in BENCHMARK.json
    spec: Dict[str, Any]          # workloads/<cell>.json
    config: Dict[str, Any]        # configs/<config>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_cell(name: str) -> Cell:
    bench = _load_json(ROOT, 'BENCHMARK.json')
    entries = [w for w in bench['workloads'] if w['name'] == name]
    if not entries:
        raise SystemExit(f'cwm_bench: no workload {name!r} in BENCHMARK.json')
    spec = _load_json(BENCH_DIR, 'workloads', name + '.json')
    config = _load_json(BENCH_DIR, 'configs', entries[0]['config'] + '.json')
    e2e = [m for m in bench['end_to_end']
           if 'workloads' not in m or name in m['workloads']]
    # every per-layer metric lists the cells that report it
    per = [m for m in bench['per_layer'] if name in m['workloads']]
    return Cell(name, entries[0], spec, config, e2e, per)


@dataclasses.dataclass
class Window:
    """What a measured window did: ``units`` of work completed in
    ``seconds``; ``metrics`` holds the driver's end-to-end values."""
    units: int
    seconds: float
    attempted: int
    failed: int
    metrics: Dict[str, float]


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    window: Window
    spans: Dict[str, float]
    profile: Any                  # tracing.Profile
    counters: Dict[str, float]


def read_metric(name: str, ctx: Context) -> Optional[float]:
    path = os.path.join(BENCH_DIR, 'metrics', name + '.py')
    mod_name = 'cwm_bench_metric_' + name.replace('.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    value = module.read(ctx)
    if value is None:
        return None
    value = float(value)
    if not math.isfinite(value):
        raise ValueError(f'metric {name} read {value}')
    return value


def load_driver(name: str):
    return importlib.import_module(f'cwm_bench.drivers.{name}')


def _finite(v: float):
    return v if math.isfinite(v) else str(v)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device='cuda', t_start: Optional[float] = None) -> Dict:
    """Set up, warm up, measure, optionally trace, then judge. Returns the
    result object (``checks`` last)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    driver = load_driver(cell.spec['driver'])
    run = driver.Run(cell.config, cell.spec['traffic'], seed, dev)
    try:
        return _measure(cell, run, dev, seconds, trace, t_start)
    finally:
        close = getattr(run, 'close', None)
        if close is not None:
            close()


def _measure(cell: Cell, run, dev, seconds: float, trace: bool,
             t_start: float) -> Dict:
    import torch

    from cwm_bench import tracing
    cuda = dev.type == 'cuda'
    run.warmup()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    win = run.window(seconds)
    device_rec = {
        'platform': 'gpu' if cuda else 'cpu',
        'kind': torch.cuda.get_device_name(dev) if cuda else 'cpu',
        'count': 1,
        'memory_peak_bytes': (int(torch.cuda.max_memory_allocated(dev))
                              if cuda else 0)}
    metrics: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    if trace:
        spans = run.stage_spans()
        prof = tracing.profile(run.profiled_unit, dev, run.profile_units)
        ctx = Context(cell.config, cell.spec['traffic'], win, spans, prof,
                      getattr(run, 'counters', {}))
        for m in cell.per_layer:
            value = read_metric(m['name'], ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        device_rec['busy_s'] = prof.busy_s
        device_rec['window_s'] = prof.window_s
        breakdown = prof.breakdown()
    else:
        for m in cell.end_to_end:
            value = setup_s if m['name'] == 'setup_s' else \
                win.metrics[m['name']]
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    limits = cell.spec['limits']
    values = run.check()
    checks = {k: {'value': float(values[k]), 'limit': float(limits[k])}
              for k in limits if k in values}
    correct = (len(checks) == len(limits)
               and all(c['value'] <= c['limit'] for c in checks.values()))
    readings = {k: float(v) for k, v in values.items() if k not in limits}
    result = {'correct': bool(correct), 'attempted': win.attempted,
              'failed': win.failed, 'metrics': metrics, 'device': device_rec}
    if breakdown is not None:
        result['breakdown'] = breakdown
    if readings:
        result['readings_not_compared'] = readings
    result['checks'] = {k: {'value': _finite(c['value']),
                            'limit': c['limit']} for k, c in checks.items()}
    return result


def check_lines(checks: Dict[str, Dict[str, Any]]) -> List[str]:
    """One line per number compared: its name, value and limit."""
    return [f'check {k}: {c["value"]!r} (limit {c["limit"]!r})'
            for k, c in checks.items()]
