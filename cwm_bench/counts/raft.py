"""FLOP count of RAFT's counterfactual probe, a frozen copy of the port's
``scripts/bench.py:raft_flops``. It is rough by its source's own account:
the feature and context encoders at ~5.4 GF per 224 px frame and ~3.75 GF
per refinement iteration and sample are estimates, not a count of the
convolutions; the correlation and the upsampling are counted from shapes.
"""
from __future__ import annotations


def raft_flops(s: int, hw: int = 224, iters: int = 24) -> float:
    """One shared frame-0 pass and S frame-1 passes of the encoders, the
    correlation volume, ``iters`` refinement iterations and the convex
    upsampling, for S samples at 224 px (``hw`` is kept for the port's
    signature; the estimates are for 224 px)."""
    enc = 5.4e9 * (s + 2)
    per_iter = 3.75e9 * s
    corr = 2 * s * 784 * 784 * 256
    upsample = s * 784 * 9 * 64 * 2 * 2
    return enc + iters * per_iter + corr + upsample
