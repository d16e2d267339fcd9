"""The arithmetic of the f32 attention kernel (csrc/attention.cu,
``attention_fwd_tf32``), emulated in plain torch on the CPU.

The kernel runs f32 attention on the tensor cores in tf32 with split
products: each operand x is hi + lo, hi = x rounded to tf32 (to nearest,
ties away: the 13 low bits of the f32 pattern), lo = x - hi; a product is
lo.hi + hi.lo + hi.hi in f32. The emulation below does that per key tile
of the kernel's width, with its online softmax in the exp2 domain, both
panels with their weights (applied once, at the panel switch) and the
stored logsumexp. It is held against float64 attention, the port's plain
versions and the JAX Pallas kernels run in interpret mode, within
chip_smoke.py's f32 tolerances (TOL_F32, TOL_K2_F32, TOL_LSE) with a
margin of 4; one tf32 pass (hi.hi alone) is shown to fail them, so a
kernel that dropped the lo terms could not pass the card's checks.
"""
import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from counterfactualworldmodels_tpu.ops import flash_attention as jfa
from counterfactualworldmodels_tpu_torch.ops import flash_attention as tfa

_spec = importlib.util.spec_from_file_location(
    'chip_smoke', os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'chip_smoke.py'))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LOG2E = 1.4426950408889634
MARGIN = 4.0


def _tf32(x):
    """x rounded to tf32 by integer operations on its f32 pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(a, b, passes):
    """a @ b as the kernel forms it: lo.hi + hi.lo + hi.hi (passes=3) or
    hi.hi alone (passes=1), f32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = a - ah, b - bh
    return (al @ bh + ah @ bl) + ah @ bh


def _key_tile(d):
    """The kernel's keys per tile at (padded) head dim d."""
    return 16 if tfa.kernel_head_dim(d) == 128 else 64


def _emulate_row(q, panels, bk, passes):
    """One (sample, head): q [Nq, D]; panels [(k [N, D], v [N, D], w)].
    Returns (out [Nq, D], lse [Nq])."""
    nq, d = q.shape
    m = torch.full((nq,), -math.inf)
    l = torch.zeros(nq)
    acc = torch.zeros(nq, d)
    w_prev = None
    for k, v, w in panels:
        if w_prev is not None:  # panel 1 begins: into its weight's units
            acc, l = acc * (w_prev / w), l * (w_prev / w)
        w_prev = w
        for r0 in range(0, k.shape[0], bk):
            s = _product(q, k[r0:r0 + bk].T, passes)
            m_new = torch.maximum(m, s.max(1).values * LOG2E)
            base = torch.where(m_new == -math.inf, torch.zeros_like(m_new),
                               m_new)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s * LOG2E - base[:, None])
            l = l * alpha + p.sum(1)
            m = m_new
            acc = acc * alpha[:, None] + _product(p, v[r0:r0 + bk], passes)
    return acc / l[:, None], m / LOG2E + torch.log(l * w_prev)


def _emulate(q, k0, v0, w0, k1=None, v1=None, w1=1.0, passes=3):
    """[S, H, Nq, D] through the kernel's arithmetic; k0/v0 may have batch
    1 (the shared prefix, read by every sample)."""
    bk = _key_tile(q.shape[-1])
    outs = torch.empty_like(q)
    lses = torch.empty(q.shape[:3])
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            b0 = b if k0.shape[0] > 1 else 0
            panels = [(k0[b0, h], v0[b0, h], w0)]
            if k1 is not None:
                panels.append((k1[b, h], v1[b, h], w1))
            outs[b, h], lses[b, h] = _emulate_row(q[b, h], panels, bk, passes)
    return outs, lses


def _dense_f64(q, k0, v0, w0, k1=None, v1=None, w1=1.0):
    """float64 attention over [k0 ; k1] with +ln w logit biases."""
    s_ = q.shape[0]
    ks, vs, bias = [k0.expand(s_, -1, -1, -1)], [v0.expand(s_, -1, -1, -1)], \
        [torch.full((k0.shape[2],), math.log(w0), dtype=torch.float64)]
    if k1 is not None:
        ks.append(k1)
        vs.append(v1)
        bias.append(torch.full((k1.shape[2],), math.log(w1),
                               dtype=torch.float64))
    k = torch.cat(ks, 2).double()
    v = torch.cat(vs, 2).double()
    s = q.double() @ k.transpose(-1, -2) + torch.cat(bias)
    return torch.softmax(s, -1) @ v, torch.logsumexp(s, -1)


# (label, S, H, Nq, N0, N1, D, S0, w0, w1); N1 = 0: one panel (K1 / K5)
CASES = [
    ('K1 D16 ragged', 2, 2, 70, 150, 0, 16, 2, 1.0, 1.0),
    ('K1 D64 ragged', 1, 2, 100, 129, 0, 64, 1, 1.0, 1.0),
    ('K1 D128 ragged', 1, 2, 50, 77, 0, 128, 1, 1.0, 1.0),
    ('K2 D64 shared prefix w 16/16', 2, 2, 37, 70, 21, 64, 1, 16.0, 16.0),
    ('K2 D16 stacked prefixes w 1/4', 2, 2, 37, 70, 21, 16, 2, 1.0, 4.0),
]


def _inputs(case):
    _, s, h, nq, n0, n1, d, s0, _, _ = case
    rng = np.random.RandomState(n0 + n1 + d)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    q = t(s, h, nq, d, scale=d ** -0.5)
    k0, v0 = t(s0, h, n0, d), t(s0, h, n0, d)
    k1 = v1 = None
    if n1:
        k1, v1 = t(s, h, n1, d), t(s, h, n1, d)
    return q, k0, v0, k1, v1


def _tol(case):
    return chip_smoke.TOL_K2_F32 if case[5] else chip_smoke.TOL_F32


def _lse_excess(lse, ref):
    """max of |lse - ref| / (atol + rtol |ref|) under TOL_LSE: <= 1 passes."""
    tol = chip_smoke.TOL_LSE
    return float(((lse.double() - ref).abs()
                  / (tol['atol'] + tol['rtol'] * ref.abs())).max())


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_split_tf32_arithmetic_holds_the_f32_tolerances(case):
    """Three passes: within the tolerance / MARGIN of float64 attention, of
    the port's plain version and of the JAX Pallas kernel (interpret mode),
    and the lse within TOL_LSE / MARGIN of float64's."""
    q, k0, v0, k1, v1 = _inputs(case)
    w0, w1 = case[8], case[9]
    out, lse = _emulate(q, k0, v0, w0, k1, v1, w1)
    ref, ref_lse = _dense_f64(q, k0, v0, w0, k1, v1, w1)
    tol = _tol(case) / MARGIN
    assert _err(out, ref) <= tol
    assert _lse_excess(lse, ref_lse) <= 1 / MARGIN
    if k1 is None:
        plain = tfa.dense_attention(q, k0, v0)
        jax_out = jfa.flash_attention(jnp.asarray(q.numpy()),
                                      jnp.asarray(k0.numpy()),
                                      jnp.asarray(v0.numpy()), interpret=True)
    else:
        plain = tfa._dense_attention_prefix(q, k0, v0, k1, v1, w0, w1)
        jax_out = jfa.flash_attention_prefix(
            *(jnp.asarray(a.numpy()) for a in (q, k0, v0, k1, v1)),
            interpret=True, prefix_weight=w0, suffix_weight=w1)
    assert _err(out, plain) <= tol
    assert _err(out, torch.from_numpy(np.array(jax_out))) <= tol


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_one_tf32_pass_fails_the_f32_tolerances(case):
    """hi.hi alone (what a kernel that dropped the lo terms computes) misses
    the output tolerance against float64 attention by more than MARGIN,
    where three passes stay MARGIN inside it, and misses TOL_LSE."""
    q, k0, v0, k1, v1 = _inputs(case)
    w0, w1 = case[8], case[9]
    out, lse = _emulate(q, k0, v0, w0, k1, v1, w1, passes=1)
    ref, ref_lse = _dense_f64(q, k0, v0, w0, k1, v1, w1)
    assert _err(out, ref) > _tol(case) * MARGIN
    assert _lse_excess(lse, ref_lse) > 1


def test_split_tf32_lse_matches_the_jax_training_forward():
    """The emulated K5 lse (natural-log units, m ln 2 + ln l) against the
    JAX kernel's _flash_bhnd_lse, the port's plain K5 and float64, ragged
    on both axes, within TOL_LSE / MARGIN."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 3, n, 64).astype(np.float32)
                                * 0.3) for n in (200, 333, 333))
    _, lse = _emulate(q, k, v, 1.0)
    _, jax_lse = jfa._flash_bhnd_lse(jnp.asarray(q[0].numpy()),
                                     jnp.asarray(k[0].numpy()),
                                     jnp.asarray(v[0].numpy()), 64, 128, True)
    _, plain_lse = tfa.dense_attention(q, k, v, with_lse=True)
    _, ref_lse = _dense_f64(q, k, v, 1.0)
    for other in (torch.from_numpy(np.array(jax_lse))[None], plain_lse,
                  ref_lse):
        assert _lse_excess(lse, other.double()) <= 1 / MARGIN
