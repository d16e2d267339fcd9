"""The arithmetic of the f32 attention backward (csrc/attention_bwd.cu,
``dkdv_tf32`` and ``dq_tf32``), emulated in plain torch on the CPU.

The kernels run K6 on the tensor cores in tf32 with split products: each
operand x is hi + lo, hi = x rounded to tf32 (to nearest, ties away: the
13 low bits of the f32 pattern), lo = x - hi; a product is
lo.hi + hi.lo + hi.hi in f32. The emulation does that at the kernels' own
tile widths (streamed tiles of 32 rows, 16 at head dim 128): pass 1 walks
the query tiles, rebuilding S^T and dP^T over the whole head dim and
adding each tile's P^T.dO and dS^T.Q, formed in a fresh accumulator, to
dV and dK in f32; pass 2 walks the key tiles and adds each tile's dS.K to
dQ the same way. It is held against float64, the port's plain version
``_chunked_attention_bwd`` and the JAX Pallas kernel ``_flash_bwd_bhnd`` in
interpret mode, fed the same residuals, within chip_smoke.py's TOL_GRAD
with a margin of 4, at head dims 16, 64 and 128 on ragged shapes; one tf32
pass (hi.hi alone) is shown to miss dq's TOL_GRAD by more than that
margin, so a kernel that dropped the lo terms could not pass the card's
checks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from counterfactualworldmodels_tpu.ops import flash_attention as jfa
from counterfactualworldmodels_tpu_torch.ops import flash_attention as tfa

from test_torch_attention_split_tf32 import LOG2E, MARGIN, _product, chip_smoke


def _tile(d):
    """The kernels' streamed rows per tile at (padded) head dim d."""
    return 16 if tfa.kernel_head_dim(d) == 128 else 32


def _probs(s, lse):
    return torch.exp2(s * LOG2E - lse * LOG2E)


def _emulate_row(q, k, v, do, lse, delta, passes):
    """One (sample, head): q, do [Nq, D]; k, v [Nk, D]; lse, delta [Nq].
    Returns (dq, dk, dv)."""
    bt = _tile(q.shape[1])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r0 in range(0, q.shape[0], bt):  # pass 1: query tiles
        qt, dot = q[r0:r0 + bt], do[r0:r0 + bt]
        p = _probs(_product(k, qt.T, passes), lse[r0:r0 + bt])
        ds = p * (_product(v, dot.T, passes) - delta[r0:r0 + bt])
        dv = dv + _product(p, dot, passes)
        dk = dk + _product(ds, qt, passes)
    dq = torch.zeros_like(q)
    for r0 in range(0, k.shape[0], bt):  # pass 2: key tiles
        kt, vt = k[r0:r0 + bt], v[r0:r0 + bt]
        p = _probs(_product(q, kt.T, passes), lse[:, None])
        ds = p * (_product(do, vt.T, passes) - delta[:, None])
        dq = dq + _product(ds, kt, passes)
    return dq, dk, dv


def _emulate(q, k, v, do, lse, delta, passes=3):
    """[B, H, N, D] through the kernels' arithmetic."""
    out = [torch.empty_like(t) for t in (q, k, v)]
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            grads = _emulate_row(q[b, h], k[b, h], v[b, h], do[b, h],
                                 lse[b, h], delta[b, h], passes)
            for o, g in zip(out, grads):
                o[b, h] = g
    return out


def _inputs(shape):
    """Seeded q (scaled by D^-1/2), k, v, dO and the residuals: lse and
    delta from float64 attention, as float32."""
    b, h, nq, nk, d = shape
    rng = np.random.RandomState(sum(shape))

    def t(*s, scale=1.0):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))

    q, k, v, do = (t(b, h, nq, d, scale=d ** -0.5), t(b, h, nk, d),
                   t(b, h, nk, d), t(b, h, nq, d))
    s = q.double() @ k.double().transpose(-1, -2)
    lse = torch.logsumexp(s, -1)
    out = torch.softmax(s, -1) @ v.double()
    delta = (do.double() * out).sum(-1)
    return q, k, v, do, lse.float(), delta.float()


def _grads_f64(q, k, v, do, lse, delta):
    """float64 K6 on the given residuals."""
    q, k, v, do, lse, delta = (t.double() for t in (q, k, v, do, lse, delta))
    p = torch.exp(q @ k.transpose(-1, -2) - lse[..., None])
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
    return ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


def _excess(a, ref):
    """max of |a - ref| / (atol + rtol |ref|) under TOL_GRAD: <= 1 passes."""
    tol = chip_smoke.TOL_GRAD
    ref = ref.double()
    return float(((a.double() - ref).abs()
                  / (tol['atol'] + tol['rtol'] * ref.abs())).max())


# (b, h, Nq, Nk, D): ragged against the kernels' 32-row tiles (16 at D 128),
# their 128-row blocks and the JAX kernel's 128-row blocks
SHAPES = [(2, 2, 100, 77, 16), (1, 2, 200, 333, 64), (1, 2, 70, 90, 128)]


@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_split_tf32_backward_holds_tol_grad(shape):
    """Three passes: dq, dk and dv within TOL_GRAD / MARGIN of float64, of
    the port's plain version and of the JAX Pallas kernel (interpret mode),
    on the same residuals."""
    q, k, v, do, lse, delta = _inputs(shape)
    got = _emulate(q, k, v, do, lse, delta)
    ref = _grads_f64(q, k, v, do, lse, delta)
    plain = tfa._chunked_attention_bwd(q, k, v, do, lse, delta)
    jax_grads = [jfa._flash_bwd_bhnd(
        *(jnp.asarray(t[b].numpy()) for t in (q, k, v, do, lse, delta)),
        128, 128, True) for b in range(q.shape[0])]
    for i, name in enumerate(('dq', 'dk', 'dv')):
        jax_g = torch.from_numpy(np.stack([np.asarray(g[i])
                                           for g in jax_grads]))
        for other in (ref[i], plain[i], jax_g):
            assert _excess(got[i], other) <= 1 / MARGIN, name


@pytest.mark.parametrize('shape', SHAPES + [(1, 1, 1000, 777, 64)], ids=str)
def test_one_tf32_pass_misses_dq_tolerance(shape):
    """hi.hi alone (what a kernel that dropped the lo terms computes) misses
    dq's TOL_GRAD against float64 by more than MARGIN, where three passes
    stay MARGIN inside it."""
    q, k, v, do, lse, delta = _inputs(shape)
    ref = _grads_f64(q, k, v, do, lse, delta)
    three = _emulate(q, k, v, do, lse, delta)
    one = _emulate(q, k, v, do, lse, delta, passes=1)
    assert _excess(three[0], ref[0]) <= 1 / MARGIN
    assert _excess(one[0], ref[0]) > MARGIN
