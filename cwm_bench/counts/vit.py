"""FLOP counts of the VMAE, from shapes.

``vit_flops`` is a frozen copy of the port's
``scripts/bench.py:vit_flops`` (the JAX bench's), taking the
configuration's ``vmae`` group instead of the model object.
``vmae_train_flops`` is the analytic count of one training step."""
from __future__ import annotations

from typing import Dict


def grid(v: Dict) -> int:
    return v['img_size'] // v['patch_size']


def patches_per_frame(v: Dict) -> int:
    return grid(v) ** 2


def out_dim(v: Dict) -> int:
    return v['in_chans'] * v['tubelet_size'] * v['patch_size'] ** 2


def _block(nq: int, nk: int, d: int, mlp: float = 4) -> int:
    mm = 2 * nq * d * d * (3 + 1 + 2 * mlp)        # qkv + proj + mlp
    attn = 4 * nq * nk * d
    return int(mm + attn)


def vit_flops(v: Dict, s: int, n_sfx: int, prefix_pool: int = 1,
              suffix_pool: int = 1) -> int:
    """Analytic MAC*2 count of one shared-prefix dispatch of S samples
    with ``n_sfx`` visible frame-1 tokens each. The pools shrink only the
    decoder attention's key set (the QKV / projection / MLP matmuls and
    all queries stay full resolution)."""
    n0 = patches_per_frame(v)
    n1 = n0 * (v['num_frames'] // v['tubelet_size']) - n0
    de, dd = v['encoder_embed_dim'], v['decoder_embed_dim']
    le, ld = v['encoder_depth'], v['decoder_depth']
    mlp = v['mlp_ratio']
    patch_dim = v['tubelet_size'] * v['patch_size'] ** 2 * v['in_chans']
    prefix = le * _block(n0, n0, de, mlp) + ld * _block(n0, n0, dd, mlp)
    prefix += 2 * n0 * de * dd                          # encoder_to_decoder
    nk_dec = n0 // prefix_pool ** 2 + n1 // suffix_pool ** 2
    suffix = s * (le * _block(n_sfx, n0 + n_sfx, de, mlp) +
                  ld * _block(n1, nk_dec, dd, mlp))
    embed = (n0 + s * n_sfx) * 2 * patch_dim * de
    head = s * n1 * 2 * dd * out_dim(v)
    return prefix + suffix + embed + head


def vmae_train_flops(v: Dict, batch: int, n_vis: int) -> int:
    """Forward MAC*2 of one masked-prediction step (encoder over n_vis
    tokens, decoder over all), x3 for the backward: a frozen copy of the
    port's ``training/flops.py:vmae_train_flops`` (the JAX bench's
    analytic count). Recomputation under remat is not counted."""
    n = patches_per_frame(v) * (v['num_frames'] // v['tubelet_size'])
    de, dd = v['encoder_embed_dim'], v['decoder_embed_dim']
    le, ld = v['encoder_depth'], v['decoder_depth']
    patch_dim = v['tubelet_size'] * v['patch_size'] ** 2 * 3

    def block(nq, nk, d, mlp=4):
        return 2 * nq * d * d * (3 + 1 + 2 * mlp) + 4 * nq * nk * d

    fwd = (le * block(n_vis, n_vis, de) + ld * block(n, n, dd)
           + n_vis * 2 * patch_dim * de + 2 * n_vis * de * dd
           + (n - n_vis) * 2 * dd * out_dim(v))
    return 3 * fwd * batch
