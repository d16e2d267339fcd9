"""Tracing and profiling utilities.

Port of counterfactualworldmodels_tpu/utils/profiling.py: a
``torch.profiler`` trace (Chrome trace, viewable in Perfetto or
chrome://tracing) in place of the XLA profiler's, and a JSONL metrics
logger with the JAX package's report and record formats.

The span registry names the stages of a counterfactual dispatch and of a
training step where they run:

- ``span(name)`` opens a stage; ``span(name, request=True)`` a request's
  root (one dispatch, one step), whose id every span inside it carries.
  With nothing collecting and no ``torch.profiler`` active it returns one
  shared no-op context (``NO_SPAN``). Under an active profiler a stage,
  not a root, opens ``record_function(name)``: its host interval lands on
  the trace's timeline beside the kernels it launched.
- ``count(name, n)`` adds to a counter while collecting. A counter named
  ``host_sync.<site>`` counts the host's waits for the device at one site
  of the code, on every device alike: a read of device values on the
  host, or a copy from pageable host memory to the device (which waits
  for the stream's queue).
- ``collect()`` opens a collection: each span records its name, id,
  parent, request, host interval and device time (a pair of CUDA timing
  events on the current stream, resolved after one synchronise when the
  collection ends; without CUDA, the host time). Spans and counters stay
  in memory; ``Collection`` sums them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from .. import kernels


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


# -- the span registry ----------------------------------------------------

@dataclasses.dataclass
class SpanRecord:
    """One recorded span.

    ``request`` is the id of the request root the span lies in (the root's
    own id for a root; None outside any root); ``device_s`` is resolved
    when the collection ends."""
    name: str
    id: int
    parent: Optional[int]
    request: Optional[int]
    host_start: float
    host_end: float = 0.0
    device_s: float = 0.0

    @property
    def host_s(self) -> float:
        return self.host_end - self.host_start


class Collection:
    """The spans and counters of one ``collect()`` block.

    Read it after the block has ended. ``counters`` holds ``count``'s
    counters and ``launches.<wrapper>``, the launches ``kernels.LAUNCHES``
    gained during the block."""

    def __init__(self, cuda: bool):
        self.records: List[SpanRecord] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self._cuda = cuda
        self._events: Dict[int, List] = {}    # span id -> [start, end]
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._launches0 = dict(kernels.LAUNCHES)

    def _open(self, name: str, request: bool) -> SpanRecord:
        stack = _open_spans()
        parent = stack[-1] if stack else None
        rec = SpanRecord(name, next(self._ids),
                         None if parent is None else parent.id, None, 0.0)
        rec.request = (rec.id if request else
                       None if parent is None else parent.request)
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events[rec.id] = [start]
        rec.host_start = time.perf_counter()
        stack.append(rec)
        return rec

    def _close(self, rec: SpanRecord) -> None:
        rec.host_end = time.perf_counter()
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events[rec.id].append(end)
        stack = _open_spans()
        if stack and stack[-1] is rec:
            stack.pop()
        self.records.append(rec)

    def _finish(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()
        for rec in self.records:
            events = self._events.pop(rec.id, None)
            rec.device_s = (events[0].elapsed_time(events[1]) / 1e3
                            if events else rec.host_s)
        self.records.sort(key=lambda r: r.id)
        for name, n in kernels.LAUNCHES.items():
            gained = n - self._launches0.get(name, 0)
            if gained:
                self.counters['launches.' + name] = gained

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Per span name: its count, times and self times.

        ``count``, ``host_s``, ``device_s`` and ``self_host_s``,
        ``self_device_s`` (each span's time less the part its children
        cover), summed over the collection."""
        covered: Dict[int, List[float]] = defaultdict(lambda: [0.0, 0.0])
        for r in self.records:
            if r.parent is not None:
                covered[r.parent][0] += r.host_s
                covered[r.parent][1] += r.device_s
        out: Dict[str, Dict[str, float]] = {}
        for r in self.records:
            t = out.setdefault(r.name, {'count': 0, 'host_s': 0.0,
                                        'device_s': 0.0, 'self_host_s': 0.0,
                                        'self_device_s': 0.0})
            child_host, child_device = covered.get(r.id, (0.0, 0.0))
            t['count'] += 1
            t['host_s'] += r.host_s
            t['device_s'] += r.device_s
            t['self_host_s'] += r.host_s - child_host
            t['self_device_s'] += r.device_s - child_device
        return out


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()
_COLLECTION: Optional[Collection] = None
_THREAD = threading.local()


def _open_spans() -> List[SpanRecord]:
    """This thread's open spans, innermost last."""
    stack = getattr(_THREAD, 'spans', None)
    if stack is None:
        stack = _THREAD.spans = []
    return stack


class _Span:
    __slots__ = ('_name', '_request', '_col', '_range', '_rec')

    def __init__(self, name: str, request: bool,
                 col: Optional[Collection]):
        self._name, self._request, self._col = name, request, col
        self._range = self._rec = None

    def __enter__(self):
        if not self._request and torch.autograd._profiler_enabled():
            self._range = torch.autograd.profiler.record_function(self._name)
            self._range.__enter__()
        if self._col is not None:
            self._rec = self._col._open(self._name, self._request)
        return self._rec

    def __exit__(self, *exc):
        if self._rec is not None:
            self._col._close(self._rec)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, request: bool = False):
    """The block as the span ``name``.

    While collecting it is recorded; under an active profiler a stage (not
    a request's root, ``request=True``) is also a ``record_function``
    range. Otherwise this is the shared no-op ``NO_SPAN``."""
    col = _COLLECTION
    if col is None and not torch.autograd._profiler_enabled():
        return NO_SPAN
    return _Span(name, request, col)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while collecting."""
    col = _COLLECTION
    if col is not None:
        with col._lock:
            col.counters[name] += n


@contextlib.contextmanager
def collect():
    """Collect spans and counters over the block.

    Yields a fresh ``Collection``, whose device times are resolved when the
    block ends. Collections do not nest."""
    global _COLLECTION
    if _COLLECTION is not None:
        raise RuntimeError('a span collection is already open')
    col = Collection(torch.cuda.is_available() and torch.cuda.is_initialized())
    _COLLECTION = col
    try:
        yield col
    finally:
        _COLLECTION = None
        col._finish()


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
