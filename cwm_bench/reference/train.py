"""Plain VideoMAE masked-prediction training steps (Tong et al., 2022;
VideoMAE's run_mae_pretraining with the CWM configuration), for the output
check of a training cell.

The loss is the mean squared error of the decoder's prediction at the
masked patches against the ImageNet-normalised clip's patch pixels, each
patch normalised by its own mean and variance (eps 1e-6). The encoder sees
the visible tokens (in index order), the decoder every token: the visible
ones first, then a mask token with the position of each masked patch (in
index order). The optimizer is global-norm clipping, then AdamW with
decoupled weight decay on every parameter, at a warm-up / cosine learning
rate. Everything is float32 (or the FP8 control's products), per clip with
its gradient summed over the batch, and each block recomputed in the
backward (``torch.utils.checkpoint``) so that one clip's f32 graph fits.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from .precision import F32, f32_mode
from .vmae import RefVMAE, normalize


def patch_pixels(frames: torch.Tensor, p: int) -> torch.Tensor:
    """[B, 3, H, W] -> [B, (H/p)(W/p), p*p*3], pixels in (py, px, c)
    order."""
    b, c, h, w = frames.shape
    x = frames.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


class TrainRef(RefVMAE):
    def block(self, pre: str, x, heads: int):
        q, k, v = self.qkv(pre, x, heads)
        return self.finish(pre, x, self.attend(q, [(k, v, 1.0)]), 'erf')

    def loss(self, clip: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """clip [2, 3, H, W] in [0, 1]; mask bool [N] (True = masked)."""
        v, s = self.v, self.sd
        xm = normalize(clip)
        n = mask.shape[0]
        tokens = self.embed(xm).reshape(1, n, -1) + self.pos_enc[None]
        vis = torch.nonzero(~mask).flatten()
        hid = torch.nonzero(mask).flatten()
        x = tokens[:, vis]
        for i in range(v['encoder_depth']):
            x = checkpoint(self.block, f'encoder.blocks.{i}', x,
                           v['encoder_num_heads'], use_reentrant=False)
        x = self.ln(x, s['encoder.norm.weight'], s['encoder.norm.bias'])
        z = self.linear(x, s['encoder_to_decoder.weight'])
        cd = z.shape[-1]
        z = torch.cat([z + self.pos_dec[vis][None],
                       s['mask_token'].reshape(1, 1, cd)
                       + self.pos_dec[hid][None]], dim=1)
        for i in range(v['decoder_depth']):
            z = checkpoint(self.block, f'decoder.blocks.{i}', z,
                           v['decoder_num_heads'], use_reentrant=False)
        z = z[:, vis.shape[0]:]
        z = self.ln(z, s['decoder.norm.weight'], s['decoder.norm.bias'])
        pred = self.linear(z, s['decoder.head.weight'], s['decoder.head.bias'])
        target = patch_pixels(xm, v['patch_size']).reshape(1, n, -1)[:, hid]
        mean = target.mean(-1, keepdim=True)
        var = target.var(-1, keepdim=True, unbiased=False)
        target = (target - mean) / torch.sqrt(var + 1e-6)
        return ((pred - target) ** 2).mean()


def learning_rate(opt: Dict, count: int) -> float:
    """The rate of the update made at step ``count`` (0 for the first):
    linear warm-up from 0 over ``warmup_steps``, then a cosine decay to 0
    at ``total_steps``."""
    warm = opt['warmup_steps']
    lr = opt['learning_rate']
    if count < warm:
        return lr * count / warm
    decay = max(opt['total_steps'], warm + 1) - warm
    t = min(count - warm, decay)
    return lr * 0.5 * (1 + math.cos(math.pi * t / decay))


def grad_step(ref: TrainRef, clips, masks, rows=None):
    """The batch's mean loss and its gradient, clip by clip. ``rows``
    limits the batch (the half-batch fault)."""
    params = list(ref.sd.values())
    for p in params:
        p.grad = None
    rows = range(clips.shape[0]) if rows is None else rows
    total = 0.0
    for i in rows:
        loss = ref.loss(clips[i], masks[i]) / len(rows)
        loss.backward()
        total += float(loss.detach())
    return total


def run_steps(sd: Dict[str, torch.Tensor], v: Dict, opt: Dict, batches,
              prec=F32, rows=None):
    """Train ``len(batches)`` steps of (clips [B, 2, 3, H, W], masks
    [B, N]) from ``sd``. Returns (losses, {leaf: the first step's
    clipped gradient}, {leaf: the parameters after the last step})."""
    b1, b2, eps = opt['b1'], opt['b2'], 1e-8
    with f32_mode():
        params = {k: t.detach().float().clone().requires_grad_(True)
                  for k, t in sd.items()}
        ref = TrainRef(params, v, prec)
        m = {k: torch.zeros_like(t) for k, t in params.items()}
        u = {k: torch.zeros_like(t) for k, t in params.items()}
        losses: List[float] = []
        first = {}
        for step, (clips, masks) in enumerate(batches):
            losses.append(grad_step(ref, clips, masks, rows))
            with torch.no_grad():
                grads = {k: p.grad for k, p in params.items()}
                gnorm = torch.sqrt(sum((g.double() ** 2).sum()
                                       for g in grads.values()))
                factor = opt['clip_norm'] / max(float(gnorm),
                                                opt['clip_norm'])
                lr = learning_rate(opt, step)
                t = step + 1
                for k, p in params.items():
                    g = grads[k] * factor
                    if step == 0:
                        first[k] = g.clone()
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    u[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (m[k] / (1 - b1 ** t)) / (
                        torch.sqrt(u[k] / (1 - b2 ** t)) + eps)
                    p.sub_(lr * (upd + opt['weight_decay'] * p))
        return losses, first, {k: p.detach() for k, p in params.items()}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              leaves=None) -> float:
    """The worst leaf's gap between two per-leaf norms, over the larger
    of the reference's norm of that leaf and its median leaf norm."""
    leaves = sorted(want) if leaves is None else leaves
    med = float(torch.tensor([want[k] for k in leaves]).median())
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in leaves)


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.float().norm()) for k, t in tensors.items()}


def moving_leaves(grad_norms: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is more than a thousandth of the
    median leaf's: the others move by round-off alone."""
    med = float(torch.tensor(list(grad_norms.values())).median())
    return sorted(k for k, g in grad_norms.items() if g > 1e-3 * med)


def judge(sd, v: Dict, opt: Dict, batches, program: Dict) -> Dict[str, float]:
    """program: {'losses': [...], 'grad_norms': {leaf: norm of the first
    step's clipped gradient}, 'change_norms': {leaf: norm of the change
    after the steps}}. Returns the numbers compared."""
    losses, first, after = run_steps(sd, v, opt, batches)
    g_ref = norms(first)
    change = norms({k: after[k] - sd[k].float() for k in after})
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program['losses'],
                                                      losses))
    return {'loss_rel_err': loss_gap,
            'grad_norm_gap': leaf_gaps(program['grad_norms'], g_ref),
            'update_norm_gap': leaf_gaps(program['change_norms'], change,
                                         moving_leaves(g_ref))}


def reference_as_program(sd, v: Dict, opt: Dict, batches, prec=F32,
                         rows=None, frozen: bool = False) -> Dict:
    """What ``judge`` reads from the program, from the reference in its
    place: in ``prec`` (the FP8 control), on ``rows`` of each batch (the
    half-batch fault), or with ``frozen`` parameters (a step that returns
    its state unchanged)."""
    losses, first, after = run_steps(sd, v, opt, batches, prec, rows)
    change = {k: (torch.zeros_like(t) if frozen else t - sd[k].float())
              for k, t in after.items()}
    return {'losses': losses, 'grad_norms': norms(first),
            'change_norms': norms(change)}
