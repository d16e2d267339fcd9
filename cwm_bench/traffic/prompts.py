"""The counterfactual traffic: seeded scenes and motion prompts.

A frozen copy of the port's demo prompt policy
(``scripts/_bench_common.demo_prompts``) and scene maker
(``demo_static_movie``: a seeded random image in both frames), drawn on
the device from a ``torch.Generator``. Per sample: frame 0 fully visible,
``passive`` visible frame-1 patches and one active frame-1 patch moved by
a shift in [-max_shift, max_shift] patches on each axis.

One departure from the copy keeps every prompt's visible count exact: the
shifted active patch lands inside the grid, and the passive patches avoid
the active patch and its target. Every sample then shows exactly
passive + 1 frame-1 patches, so the program's rectangularizer has nothing
to fill and its random draws cannot change a mask.
"""
from __future__ import annotations

import dataclasses

import torch

MASK64 = (1 << 63) - 1


def call_seed(seed: int, call: int, stream: int = 0) -> int:
    """The generator seed of one call's draws (any size of ``seed``)."""
    return (seed * 1_000_003 + call * 7_919 + stream * 104_729) & MASK64


@dataclasses.dataclass
class Prompts:
    """One call's inputs. scene [3, H, W] in [0, 1]; active [S] and
    passive [S, P] flat frame-1 patch indices; shifts [S, 2] (dy, dx) in
    patches; the masks [1, N, S] bool (True = masked) in the layout the
    port's FlowGenerator takes."""
    scene: torch.Tensor
    active: torch.Tensor
    passive: torch.Tensor
    shifts: torch.Tensor
    active_mask: torch.Tensor
    passive_mask: torch.Tensor


def draw(seed: int, call: int, hw: int, grid: int, s: int, passive: int,
         max_shift: int, device) -> Prompts:
    g = torch.Generator(device=device)
    g.manual_seed(call_seed(seed, call))
    scene = torch.rand(3, hw, hw, generator=g, device=device)
    n1 = grid * grid
    shifts = torch.randint(-max_shift, max_shift + 1, (s, 2), generator=g,
                           device=device)
    # the active patch's row (col) is uniform over those whose target row
    # (col) lies inside the grid
    lo = (-shifts).clamp(min=0)
    span = grid - shifts.abs()
    u = torch.rand(s, 2, generator=g, device=device)
    pos = lo + (u * span).floor().long().clamp(max=span - 1)
    active = pos[:, 0] * grid + pos[:, 1]
    target = (pos[:, 0] + shifts[:, 0]) * grid + pos[:, 1] + shifts[:, 1]
    keys = torch.rand(s, n1, generator=g, device=device)
    rows = torch.arange(s, device=device)
    keys[rows, active] = 2.0
    keys[rows, target] = 2.0
    passive_idx = torch.topk(keys, passive, dim=1, largest=False).indices
    passive_idx = passive_idx.sort(dim=1).values
    n = 2 * n1
    pm = torch.ones(1, n, s, dtype=torch.bool, device=device)
    pm[:, :n1] = False
    pm[0, n1 + passive_idx, rows[:, None]] = False
    am = torch.ones(1, n, s, dtype=torch.bool, device=device)
    am[:, :n1] = False
    am[0, n1 + active, rows] = False
    return Prompts(scene, active, passive_idx, shifts, am, pm)
