"""The IMU-conditioned dispatch's executed FLOPs (counts/conjoined.py: the
conjoined engine's prefix and per-sample suffix, both streams and the
cross blocks, plus the frozen RAFT count) over the traced run's own
measured window, as a share of the H100's dense bf16 peak, in percent."""
from cwm_bench.counts import conjoined, raft, roofline


def read(ctx):
    t, m, r = ctx.traffic, ctx.config['main'], ctx.config['raft']
    s = t['num_samples']
    flops = conjoined.dispatch_flops(ctx.config, s, t['passive'] + 1)
    flops += raft.raft_flops(s, m['img_size'], r['iters'])
    w = ctx.window
    if w.units <= 0 or w.seconds <= 0:
        return None
    return 100.0 * flops * w.units / w.seconds / roofline.PEAK_BF16_FLOPS
