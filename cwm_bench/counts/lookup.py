"""Bytes and operations of RAFT's correlation window lookup, from shapes.

Each query (one 1/8-resolution pixel of one sample) reads a
(2r+2) x (2r+2) window of its own row of every pyramid level around its
coordinates, as far as the window lies inside the level, and writes
levels * (2r+1)^2 values. Each query's rows of the pyramid are its own, so
no two queries share what they read. The window is placed at the query's
own position (zero flow); where the flow moves it off the level, less is
read than counted here."""
from __future__ import annotations

from typing import Tuple


def _covered(n: int, size: int, radius: int, level: int) -> int:
    """Sum over the n grid positions of how many of the (2r+2) window
    positions along one axis fall inside a level axis of ``size``."""
    total = 0
    for i in range(n):
        c = i // (2 ** level)
        lo, hi = c - radius, c - radius + 2 * radius + 1
        total += max(0, min(hi, size - 1) - max(lo, 0) + 1)
    return total


def level_sizes(h8: int, w8: int, levels: int):
    sizes = [(h8, w8)]
    for _ in range(levels - 1):
        h, w = sizes[-1]
        sizes.append((h // 2, w // 2))
    return sizes


def pyramid_lookup(batch: int, h8: int, w8: int, levels: int, radius: int,
                   out_elem: int = 2) -> Tuple[float, float]:
    """(ops, bytes) of one lookup of every level for ``batch`` samples on
    an h8 x w8 grid: f32 level reads, f32 (x, y) coordinates, outputs of
    ``out_elem`` bytes. Ops: the four-tap bilinear sum, 7 per output."""
    p = 2 * radius + 1
    read = 0
    for lvl, (h, w) in enumerate(level_sizes(h8, w8, levels)):
        read += _covered(h8, h, radius, lvl) * _covered(w8, w, radius, lvl)
    queries = batch * h8 * w8
    nbytes = batch * read * 4.0 + queries * 8.0
    nbytes += queries * levels * p * p * out_elem
    ops = 7.0 * queries * levels * p * p
    return ops, nbytes
