"""The training step's model FLOPs (the frozen analytic VMAE count: the
forward x3, no recomputation) over the traced run's own measured window,
as a share of the H100's dense bf16 peak, in percent."""
from cwm_bench.counts import roofline, vit


def read(ctx):
    v, t = ctx.config['vmae'], ctx.traffic
    n0 = vit.patches_per_frame(v)
    n_vis = 2 * n0 - int(t['mask_ratio'] * n0)
    w = ctx.window
    if w.units <= 0 or w.seconds <= 0:
        return None
    flops = vit.vmae_train_flops(v, t['batch_size'], n_vis) * w.units
    return 100.0 * flops / w.seconds / roofline.PEAK_BF16_FLOPS
