"""Roofline share of the correlation window lookup in the profiled
dispatch, in percent: the least time of every RAFT iteration's lookup of
all pyramid levels for every sample (counts/lookup.py; bound by bytes)
over the device time of the kernels whose names match PATTERN: the port's
K3 (window_lookup_kernel) and PyTorch's grid_sample kernels."""
from cwm_bench.counts import lookup, roofline

PATTERN = r'window_lookup|grid_sampler'


def read(ctx):
    if ctx.profile is None:
        return None
    seconds = ctx.profile.kernel_seconds(PATTERN)
    v, r = ctx.config['vmae'], ctx.config['raft']
    h8 = v['img_size'] // 8
    ops, nbytes = lookup.pyramid_lookup(ctx.traffic['num_samples'], h8, h8,
                                        r['corr_levels'], r['corr_radius'])
    n = ctx.profile.units * r['iters']
    return roofline.share_percent(ops * n, nbytes * n, seconds)
