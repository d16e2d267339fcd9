"""Roofline share of the attention forward kernels in the profiled
IMU-conditioned dispatch, in percent: the least time of the attention work
that the conjoined engine gives them (counts/conjoined.py: K1 over the
frame-0 prefix in the main encoder and decoder, K2 over each sample's
decoder rows against [prefix ; own] keys) over the device time of the
kernels whose names match PATTERN: the port's K1/K2 and PyTorch's own
scaled-dot-product, flash and memory-efficient kernels."""
from cwm_bench.counts import conjoined, roofline

PATTERN = (r'attention_fwd|flash_fwd|fmha_cutlassF|fmha.*fwd|'
           r'scaled_dot_product|efficient_attention_forward')


def read(ctx):
    if ctx.profile is None:
        return None
    ops, nbytes = conjoined.dispatch_kernels(ctx.config,
                                             ctx.traffic['num_samples'])
    n = ctx.profile.units
    return roofline.share_percent(ops * n, nbytes * n,
                                  ctx.profile.kernel_seconds(PATTERN))
