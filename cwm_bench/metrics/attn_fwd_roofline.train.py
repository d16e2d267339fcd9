"""Roofline share of the attention forward kernels in the profiled
training step, in percent: the least time of the attention work the step
runs (counts/attention.py: the encoder over the visible tokens and the
decoder over every token; the forward as often as the configuration's
remat runs it) over the device time of the kernels whose names match
PATTERN: the port's K5 (attention_fwd_sm90 with its row statistics) and
PyTorch's own flash and memory-efficient kernels."""
from cwm_bench.counts import attention, roofline, vit

PATTERN = (r'attention_fwd|flash_fwd|fmha_cutlassF|fmha.*fwd|'
           r'scaled_dot_product|efficient_attention_forward')


def read(ctx):
    if ctx.profile is None:
        return None
    v, t = ctx.config['vmae'], ctx.traffic
    n0 = vit.patches_per_frame(v)
    n_vis = 2 * n0 - int(t['mask_ratio'] * n0)
    forwards = 2 if ctx.config['train']['remat'] else 1
    ops, nbytes = attention.train_step_kernels(
        v, t['batch_size'], n_vis, forwards)[0]
    n = ctx.profile.units
    return roofline.share_percent(ops * n, nbytes * n,
                                  ctx.profile.kernel_seconds(PATTERN))
