"""Operation count of a VMAE training step. Port of
scripts/bench_train.py:vmae_train_flops, the FLOP definition behind the
JAX package's training MFU."""
from __future__ import annotations


def vmae_train_flops(model, batch: int, n_vis: int) -> int:
    """fwd MACs*2 of one masked-prediction step (encoder over n_vis,
    decoder over all tokens), x3 for backward. ``model`` is the
    configuration (models/vmae.PretrainVisionTransformer)."""
    n = model.num_patches
    de, dd = model.encoder_embed_dim, model.decoder_embed_dim
    Le, Ld = model.encoder_depth, model.decoder_depth

    def block(nq, nk, d, mlp=4):
        return 2 * nq * d * d * (3 + 1 + 2 * mlp) + 4 * nq * nk * d

    pt, ph, pw = model.full_patch_size
    fwd = (Le * block(n_vis, n_vis, de) + Ld * block(n, n, dd)
           + n_vis * 2 * (pt * ph * pw * 3) * de + 2 * n_vis * de * dd
           + (n - n_vis) * 2 * dd * model.out_dim)
    return 3 * fwd * batch
