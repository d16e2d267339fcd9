"""Roofline share of the attention backward kernels in the profiled
training step, in percent: the least time of the attention work the step
runs (counts/attention.py: the encoder over the visible tokens and the
decoder over every token; the forward as often as the configuration's
remat runs it) over the device time of the kernels whose names match
PATTERN: the port's K6 (dkdv_sm90 and dq_sm90, or their _tf32 twins) and
PyTorch's own flash and memory-efficient kernels."""
from cwm_bench.counts import attention, roofline, vit

PATTERN = (r'dkdv|dq_sm90|dq_tf32|attention_bwd|flash_bwd|fmha_cutlassB|'
           r'efficient_attention_backward')


def read(ctx):
    if ctx.profile is None:
        return None
    v, t = ctx.config['vmae'], ctx.traffic
    n0 = vit.patches_per_frame(v)
    n_vis = 2 * n0 - int(t['mask_ratio'] * n0)
    forwards = 2 if ctx.config['train']['remat'] else 1
    ops, nbytes = attention.train_step_kernels(
        v, t['batch_size'], n_vis, forwards)[1]
    n = ctx.profile.units
    return roofline.share_percent(ops * n, nbytes * n,
                                  ctx.profile.kernel_seconds(PATTERN))
