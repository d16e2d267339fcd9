"""Sinusoidal position encodings.

Port of counterfactualworldmodels_tpu/ops/pos_embed.py: the table is built in
float64 numpy and then cast, so it matches the JAX table bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _table_np(pos: np.ndarray, d_hid: int, apply_sinusoid: bool) -> np.ndarray:
    dims = np.arange(d_hid)
    angle_rates = 1.0 / np.power(10000.0, 2 * (dims // 2) / d_hid)
    table = pos[:, None] * angle_rates[None, :]
    if apply_sinusoid:
        table[:, 0::2] = np.sin(table[:, 0::2])
        table[:, 1::2] = np.cos(table[:, 1::2])
    return table[None].astype(np.float32)


@functools.lru_cache(maxsize=32)
def _range_table(n: int, d_hid: int, apply_sinusoid: bool,
                 device: torch.device) -> torch.Tensor:
    pos = np.arange(n, dtype=np.float64)
    return torch.from_numpy(_table_np(pos, d_hid, apply_sinusoid)).to(device)


def sinusoid_encoding_table(positions, d_hid: int, apply_sinusoid: bool = True,
                            device='cpu') -> torch.Tensor:
    """[1, N, d_hid] float32 sin/cos table. ``positions`` is an int (range)
    or a sequence of position values. Even dims get sin, odd dims cos;
    frequency 10000^(2*(j//2)/d).

    Tables of a range are cached per (N, d_hid, device), since the engine
    asks for the same ones on every call: treat the result as read-only."""
    if isinstance(positions, int):
        return _range_table(positions, d_hid, apply_sinusoid,
                            torch.device(device))
    pos = np.asarray(positions, dtype=np.float64)
    return torch.from_numpy(_table_np(pos, d_hid, apply_sinusoid)).to(device)
