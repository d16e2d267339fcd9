"""The whole dispatch's executed FLOPs (the frozen ViT count at the
configuration's rung, with each sample's visible frame-1 tokens, plus the
frozen RAFT count) over the traced run's own measured window, as a share
of the H100's dense bf16 peak, in percent."""
from cwm_bench.counts import raft, roofline, vit


def read(ctx):
    v, r, rung, t = (ctx.config['vmae'], ctx.config['raft'],
                     ctx.config['rung'], ctx.traffic)
    s = t['num_samples']
    flops = vit.vit_flops(v, s, t['passive'] + 1, rung['prefix_pool'],
                          rung['suffix_pool'])
    flops += raft.raft_flops(s, v['img_size'], r['iters'])
    w = ctx.window
    if w.units <= 0 or w.seconds <= 0:
        return None
    return 100.0 * flops * w.units / w.seconds / roofline.PEAK_BF16_FLOPS
