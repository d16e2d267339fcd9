"""Tracing and profiling utilities.

Port of counterfactualworldmodels_tpu/utils/profiling.py: a
``torch.profiler`` trace (Chrome trace, viewable in Perfetto or
chrome://tracing) in place of the XLA profiler's, per-stage wall-clock
timers that wait for the device, and a JSONL metrics logger with the JAX
package's report and record formats.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _tensors(x):
    """Every tensor in a (nested) container."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for leaf in x for t in _tensors(leaf)]
    return []


def device_sync(x=None) -> None:
    """Wait for pending device work: ``torch.cuda.synchronize`` on the
    devices of the tensors in ``x`` (a tensor or a nested container), and
    with no tensor given on the current device once CUDA is in use. A
    no-op for tensors on the CPU, whose work is done when the call
    returns."""
    tensors = _tensors(x)
    if not tensors:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(dev)


def _profile(log_dir: str):
    """A torch.profiler session (CPU, and CUDA when present) that writes a
    Chrome trace into ``log_dir`` when it stops."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    def write(prof):
        prof.export_chrome_trace(os.path.join(
            log_dir, f'trace-{os.getpid()}-{time.time_ns()}.json'))

    return profile(activities=activities, on_trace_ready=write)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block, written into ``log_dir``."""
    prof = _profile(log_dir)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()


class StepTraceWindow:
    """Trace a window of training steps (the train CLIs' ``--profile-dir``):
    starts after ``warm_steps`` post-resume steps and stops ``num_steps``
    later. ``tick(step)`` once per loop iteration; no-op when log_dir is
    falsy."""

    def __init__(self, log_dir: Optional[str], first_step: int,
                 warm_steps: int = 3, num_steps: int = 3):
        self.log_dir = log_dir
        self.start_at = first_step + warm_steps
        self.stop_at = self.start_at + num_steps
        self._prof = None

    def tick(self, step: int) -> None:
        if not self.log_dir:
            return
        if self._prof is None and step == self.start_at:
            self._prof = _profile(self.log_dir)
            self._prof.start()
        elif self._prof is not None and step >= self.stop_at:
            self.close()
            print(f'profile trace written to {self.log_dir}', flush=True)

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


class StageTimer:
    """Accumulating per-stage wall-clock timer with device sync."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        # sync at entry too, or work enqueued before the stage is billed
        # to it (the stream drains inside this stage's window)
        device_sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            device_sync(sync_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {'total_s': round(self.totals[k], 4),
                    'count': self.counts[k],
                    'mean_s': round(self.totals[k] / max(self.counts[k], 1),
                                    4)}
                for k in self.totals}

    def report(self) -> str:
        lines = ['%-32s %8s %10s %10s' % ('stage', 'count', 'total(s)',
                                          'mean(s)')]
        for k, v in sorted(self.summary().items(),
                           key=lambda kv: -kv[1]['total_s']):
            lines.append('%-32s %8d %10.3f %10.4f'
                         % (k, v['count'], v['total_s'], v['mean_s']))
        return '\n'.join(lines)


class MetricsLogger:
    """Append-only JSONL metrics log (step, wall time, values)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.history = []

    def log(self, step: int, **metrics):
        rec = {'step': int(step), 'time': time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self.history.append(rec)
        if self.path:
            with open(self.path, 'a') as f:
                f.write(json.dumps(rec) + '\n')
        return rec
