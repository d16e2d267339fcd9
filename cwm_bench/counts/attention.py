"""Operations and bytes of attention, from shapes.

One attention call over ``b`` batch rows and ``h`` heads of head size
``d``: the two products (Q K^T and P V) are 4 * b * h * nq * nk * d
operations. Its bytes are each input read once and the output written
once: Q and O of every row, and K and V of each key panel, which a panel
shared by every row (the shared prefix) counts once."""
from __future__ import annotations

from typing import Dict, Tuple

from . import vit


def fwd(b: int, h: int, nq: int, d: int, panels, elem: int = 2
        ) -> Tuple[float, float]:
    """(ops, bytes) of one forward call. panels: (rows, nk) per key panel,
    rows 1 for a panel shared by the b rows or b for one of their own."""
    nk = sum(n for _, n in panels)
    ops = 4.0 * b * h * nq * nk * d
    nbytes = 2.0 * b * h * nq * d * elem
    nbytes += sum(2.0 * rows * h * n * d * elem for rows, n in panels)
    return ops, nbytes


def cf_dispatch_kernels(v: Dict, s: int, prefix_pool: int,
                        suffix_pool: int) -> Tuple[float, float]:
    """(ops, bytes) of the attention that one counterfactual dispatch of S
    samples runs on the attention kernels: the frame-0 prefix through the
    encoder and the decoder (single source, n0 x n0) and the decoder's
    frame-1 rows of every sample against the pooled prefix panel (shared)
    and their own pooled panel. The encoder suffix's visible tokens attend
    through dense products, which these kernels do not run."""
    n0 = vit.patches_per_frame(v)
    n1 = n0
    de, dd = v['encoder_embed_dim'], v['decoder_embed_dim']
    he, hd = v['encoder_num_heads'], v['decoder_num_heads']
    ops = nbytes = 0.0
    for depth, dim, heads in ((v['encoder_depth'], de, he),
                              (v['decoder_depth'], dd, hd)):
        o, b = fwd(1, heads, n0, dim // heads, [(1, n0)])
        ops += depth * o
        nbytes += depth * b
    o, b = fwd(s, hd, n1, dd // hd, [(1, n0 // prefix_pool ** 2),
                                     (s, n1 // suffix_pool ** 2)])
    ops += v['decoder_depth'] * o
    nbytes += v['decoder_depth'] * b
    return ops, nbytes


def bwd(b: int, h: int, n: int, d: int, elem: int = 2
        ) -> Tuple[float, float]:
    """(ops, bytes) of one self-attention backward over n tokens: five
    products (the scores again, dP, dV, dQ, dK), 10 * b * h * n^2 * d
    operations; it reads Q, K, V, O, dO and the row statistics (f32) and
    writes dQ, dK, dV."""
    ops = 10.0 * b * h * n * n * d
    nbytes = 8.0 * b * h * n * d * elem + 4.0 * b * h * n
    return ops, nbytes


def train_step_kernels(v: Dict, batch: int, n_vis: int, forwards: int
                       ) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """((ops, bytes) forward, (ops, bytes) backward) of the attention in
    one masked-prediction training step: the encoder's self-attention over
    the n_vis visible tokens, the decoder's over every token. ``forwards``
    is how many times the step runs each forward (2 where the backward
    recomputes it under remat); the forward also writes its row
    statistics (f32)."""
    n = vit.patches_per_frame(v) * v['num_frames'] // v['tubelet_size']
    f_ops = f_bytes = b_ops = b_bytes = 0.0
    for depth, dim, heads, tokens in (
            (v['encoder_depth'], v['encoder_embed_dim'],
             v['encoder_num_heads'], n_vis),
            (v['decoder_depth'], v['decoder_embed_dim'],
             v['decoder_num_heads'], n)):
        o, b = fwd(batch, heads, tokens, dim // heads, [(batch, tokens)])
        f_ops += forwards * depth * o
        f_bytes += forwards * depth * (b + 4.0 * batch * heads * tokens)
        o, b = bwd(batch, heads, tokens, dim // heads)
        b_ops += depth * o
        b_bytes += depth * b
    return (f_ops, f_bytes), (b_ops, b_bytes)
