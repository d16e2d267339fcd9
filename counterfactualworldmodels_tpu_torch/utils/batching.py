"""Leader-follower micro-batching for serving dispatches.

Port of counterfactualworldmodels_tpu/utils/batching.py (plain Python, kept
as its own copy). Concurrent requests that can share one device dispatch
(counterfactual prompts on the same scene, which concatenate along the
sample (S) axis of the shared-prefix dispatch, or prompts on different
scenes over stacked prefix caches) are merged: the first thread to arrive
for a batch key becomes the leader, waits a short window for followers,
and runs ONE dispatch for the whole group. Followers block on an event
and receive their slice of the result.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Hashable, List, Sequence


class _Entry:
    __slots__ = ('item', 'event', 'result', 'error')

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error = None


class MicroBatcher:
    """Merge same-key requests arriving within ``window_s`` seconds.

    dispatch(key, items) runs on the leader's thread and must return one
    result per item, in order. A batch closes when the window elapses or
    its total weight reaches ``max_items``; requests arriving after close
    start a new batch. ``weight`` maps an item to its batch weight
    (default 1 per item — then ``max_items`` counts items; serving passes
    the per-request sample count so the cap bounds SAMPLES per dispatch).
    An item that would push a batch past the cap does not join it: the
    full batch closes and the item leads a fresh one, so no dispatch ever
    exceeds ``max_items`` total weight (callers must reject single items
    heavier than the cap). A dispatch error propagates to every member of
    the batch.

    window_s=0 keeps the grouping semantics (requests racing the leader's
    lock acquisition still merge) with no added latency.
    """

    def __init__(self, dispatch: Callable[[Hashable, Sequence[Any]],
                                          List[Any]],
                 window_s: float = 0.005, max_items: int = 64,
                 weight: Callable[[Any], int] = None):
        self.dispatch = dispatch
        self.window_s = float(window_s)
        self.max_items = int(max_items)
        self.weight = weight or (lambda item: 1)
        self._lock = threading.Lock()
        self._pending = {}          # key -> {'entries', 'closed', 'weight'}
        self.batches = 0            # dispatches run
        self.batched_items = 0      # items served through them

    def run(self, key: Hashable, item: Any):
        entry = _Entry(item)
        w = max(1, int(self.weight(item)))
        with self._lock:
            batch = self._pending.get(key)
            if (batch is not None
                    and batch['weight'] + w > self.max_items):
                # joining would exceed the cap: close the open batch for
                # its leader and start a new one with this item
                batch['closed'] = True
                self._pending.pop(key, None)
                batch = None
            if batch is None:
                batch = {'entries': [entry], 'closed': False, 'weight': w}
                self._pending[key] = batch
                leader = True
            else:
                batch['entries'].append(entry)
                batch['weight'] += w
                leader = False
                if batch['weight'] >= self.max_items:
                    batch['closed'] = True
                    self._pending.pop(key, None)

        if not leader:
            entry.event.wait()
            if entry.error is not None:
                raise entry.error
            return entry.result

        if self.window_s > 0:
            deadline = time.monotonic() + self.window_s
            while time.monotonic() < deadline:
                with self._lock:
                    if batch['closed']:
                        break
                time.sleep(min(1e-3, self.window_s))
        with self._lock:
            batch['closed'] = True
            if self._pending.get(key) is batch:
                del self._pending[key]
            entries = list(batch['entries'])

        try:
            results = self.dispatch(key, [e.item for e in entries])
            if len(results) != len(entries):
                raise RuntimeError(
                    f'dispatch returned {len(results)} results for '
                    f'{len(entries)} items')
            for e, r in zip(entries, results):
                e.result = r
        except BaseException as exc:
            for e in entries[1:]:
                e.error = exc
                e.event.set()
            raise
        for e in entries[1:]:
            e.event.set()
        self.batches += 1
        self.batched_items += len(entries)
        return entries[0].result


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the largest bucket if none is); bounds the
    number of distinct compiled batch shapes."""
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)
