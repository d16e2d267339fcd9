"""Roofline share of the attention forward kernels in the profiled
dispatch, in percent: the least time of the attention work the dispatch
needs (counts/attention.py: the frame-0 prefix through the encoder and
the decoder, and the decoder's frame-1 rows against the pooled panels)
over the device time of the kernels whose names match PATTERN: the port's
K1/K2 (attention_fwd_sm90, attention_fwd_tf32) and PyTorch's own
scaled-dot-product, flash and memory-efficient kernels."""
from cwm_bench.counts import attention, roofline

PATTERN = (r'attention_fwd|flash_fwd|fmha_cutlassF|fmha.*fwd|'
           r'scaled_dot_product|efficient_attention_forward')


def read(ctx):
    if ctx.profile is None:
        return None
    seconds = ctx.profile.kernel_seconds(PATTERN)
    v, rung = ctx.config['vmae'], ctx.config['rung']
    ops, nbytes = attention.cf_dispatch_kernels(
        v, ctx.traffic['num_samples'], rung['prefix_pool'],
        rung['suffix_pool'])
    n = ctx.profile.units
    return roofline.share_percent(ops * n, nbytes * n, seconds)
