"""Operation counts of the training steps, the FLOP definitions behind the
trainers' MFU.

``vmae_train_flops`` is the port of scripts/bench_train.py:vmae_train_flops,
the JAX package's analytic count. The JAX package counts no other family;
the ChannelMAE, conjoined and RAFT counts here are counted, not derived:
torch.utils.flop_counter over one forward of the model built on the meta
device (shapes only: nothing is computed or allocated), with dense
attention so the attention products are counted too. Like the VMAE count,
they take the matmuls and convolutions of the forward, x3 for the backward,
and leave elementwise work out.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

META = torch.device('meta')


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


def counted_flops(fn: Callable[[], object]) -> int:
    """The matmul and convolution FLOPs that ``fn()`` runs, by
    torch.utils.flop_counter (on meta tensors, a count of shapes)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn()
    return int(counter.get_total_flops())


def _mask(batch: int, n: int, n_vis: int) -> torch.Tensor:
    m = torch.ones(batch, n, dtype=torch.bool, device=META)
    m[:, :n_vis] = False
    return m


def cmae_train_flops(build: Callable[[torch.device], torch.nn.Module],
                     batch: int, n_vis: int,
                     group_masked_counts: Sequence[int]) -> int:
    """One ChannelMAE train step: 3 x the forward of ``build(device)`` (a
    models/cmae.ChannelMae with dense attention) on [batch, C, H, W]."""
    m = build(META)
    x = torch.empty(batch, m.encoder.in_channels, *m.image_size, device=META)
    return 3 * counted_flops(lambda: m(x, _mask(batch, m.num_patches, n_vis),
                                       n_vis, group_masked_counts))


def conjoined_train_flops(build: Callable[[torch.device], torch.nn.Module],
                          batch: int, n_vis: int, n_vis_context: int) -> int:
    """One conjoined train step: 3 x the forward of ``build(device)`` (a
    models/conjoined.ConjoinedVMAE with dense attention, IMU context) with
    the main stream's predictions out."""
    m = build(META)
    main, ctx = m.main, m.context
    x = torch.empty(batch, main.in_chans, main.num_frames, *main.img_size,
                    device=META)
    xc = torch.empty(batch, ctx.in_chans, ctx.sequence_length, 1, 1,
                     device=META)
    mc = torch.zeros(batch, ctx.num_patches, dtype=torch.bool, device=META)
    return 3 * counted_flops(lambda: m(
        x, _mask(batch, main.num_patches, n_vis), xc, mc, n_vis,
        n_vis_context))


def raft_train_flops(build: Callable[[torch.device], torch.nn.Module],
                     batch: int, hw: int, iters: int) -> int:
    """One RAFT flow train step: 3 x the forward of ``build(device)`` (a
    models/raft.raft.RAFT with corr_lookup='gather') on image pairs
    [batch, 3, hw, hw] over ``iters`` refinement iterations."""
    m = build(META)
    im = torch.empty(batch, 3, hw, hw, device=META)
    return 3 * counted_flops(lambda: m(im, im, iters, True))
