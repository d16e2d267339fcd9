"""A short profiled window: device busy time, kernel times by name, and
the idle gaps labelled by what the host was doing.

``profile(fn, device, units)`` calls ``fn`` ``units`` times under
``torch.profiler`` (CPU and CUDA activities) inside one
``record_function('cwm_bench.window')`` range that ends after a device
synchronise, writes the Chrome trace to a temporary file under ``TMPDIR``,
reads it back and deletes it. Busy time is the union of the kernel, memcpy
and memset intervals inside that range; the window is the range itself.
Before that range the profiler runs the same ``units`` calls as its own
warm-up step, whose events it drops: the first calls under a profiler pay
its set-up, which is not the program's. ``fn`` is so called PASSES *
``units`` times in all.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Dict, List, Tuple

WINDOW = 'cwm_bench.window'
PASSES = 2                  # the profiler's warm-up step, then the window
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')


def short_name(name: str) -> str:
    """A kernel's name without its trailing argument list, at most 120
    characters."""
    name = name.strip()
    if name.endswith(')'):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {')': 1, '(': -1}.get(name[i], 0)
            if depth == 0:
                if name[:i].strip():
                    name = name[:i]
                break
    return name.strip()[:120]


@dataclasses.dataclass
class Profile:
    kernels: List[Tuple[str, float]]      # (name, seconds) per launch
    busy_s: float
    window_s: float
    units: int
    gaps: List[Tuple[str, float]]         # (host activity, seconds)

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``
        (a case-insensitive regular expression)."""
        rx = re.compile(pattern, re.I)
        return sum(s for n, s in self.kernels if rx.search(n))

    def breakdown(self) -> Dict[str, List[List]]:
        ops: Dict[str, float] = {}
        for n, s in self.kernels:
            ops[short_name(n)] = ops.get(short_name(n), 0.0) + s
        gaps: Dict[str, float] = {}
        for n, s in self.gaps:
            gaps[n] = gaps.get(n, 0.0) + s
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {'device_ops': [[n, s] for n, s in top],
                'idle_gaps': [[n, s] for n, s in idle]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _label(t: float, host: List[Tuple[float, float, str]]) -> str:
    """'outer / inner' of the host ranges that contain time t."""
    around = [(b - a, name) for a, b, name in host if a <= t <= b]
    if not around:
        return 'host: no range'
    around.sort()
    inner, outer = around[0][1], around[-1][1]
    return inner if inner == outer else f'{outer} / {inner}'


def parse_trace(events: List[Dict], units: int) -> Profile:
    window = [e for e in events
              if e.get('name') == WINDOW and e.get('cat') == 'user_annotation']
    if not window:
        raise RuntimeError('the profiled window range is not in the trace')
    w0 = float(window[0]['ts'])
    w1 = w0 + float(window[0]['dur'])
    kernels, intervals = [], []
    host: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        a = float(e['ts'])
        b = a + float(e['dur'])
        cat = e.get('cat', '')
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                kernels.append((e['name'], (b - a) * 1e-6))
                intervals.append((a, b))
        elif (cat in HOST_CATS and e.get('name') != WINDOW
              and not e.get('name', '').startswith('ProfilerStep#')):
            host.append((a, b, short_name(e['name'])))
    busy = _union(intervals)
    busy_us = sum(b - a for a, b in busy)
    gaps = []
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((_label((edge + a) / 2, host), (a - edge) * 1e-6))
        edge = max(edge, b)
    return Profile(kernels, busy_us * 1e-6, (w1 - w0) * 1e-6, units, gaps)


def profile(fn, device, units: int) -> Profile:
    import torch
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    sched = torch.profiler.schedule(wait=0, warmup=PASSES - 1, active=1,
                                    repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for step in range(PASSES):
            with record_function(WINDOW if step == PASSES - 1 else
                                 'cwm_bench.profiler_warmup'):
                for _ in range(units):
                    fn()
                if device.type == 'cuda':
                    torch.cuda.synchronize(device)
            prof.step()
    fd, path = tempfile.mkstemp(suffix='.json', prefix='cwm_bench_trace_')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.remove(path)
    return parse_trace(events, units)
