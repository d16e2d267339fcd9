"""Plain VideoMAE predictor for counterfactual prompts, at a pooled rung.

The model is VideoMAE's pre-training transformer (Tong et al., 2022) as
the Counterfactual World Models code configures it (cwm/models/VideoMAE/
vmae.py): pre-norm blocks, q and v biases, a sinusoid position table,
an encoder over the visible tokens and a narrow decoder over visible and
mask tokens, whose head predicts each masked patch's pixels.

A counterfactual prompt shows all of frame 0 and a few frame-1 patches.
The rung this reference computes is the shared-prefix factorisation with
pooled keys, written out from its definition:

- frame 0 (the prefix) runs alone through the encoder and the decoder,
  with full self-attention and the exact (erf) GELU;
- each sample's visible frame-1 tokens run through the encoder attending
  to [frame 0's keys of that layer ; their own keys];
- each sample's frame-1 rows (visible tokens and mask tokens) run through
  the decoder attending to frame 0's keys and their own, each set averaged
  over ``prefix_pool`` x ``prefix_pool`` (``suffix_pool`` x
  ``suffix_pool``) cells of the patch grid and weighted by the number of
  keys it stands for (a score bias of ln pool^2);
- the suffix's GELU is ``gelu`` ('tanh' or 'erf').

Every product runs through ``prec`` (float32, or the FP8 control); scores,
softmax, norms and sums are float32. No kernel, cache or batching of the
program is used.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import F32

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[..., 3, H, W] in [0, 1] -> ImageNet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def sinusoid_table(n: int, d: int, device) -> torch.Tensor:
    """[n, d] sin (even dims) / cos (odd dims) table, 10000^(2(j//2)/d),
    computed in float64."""
    pos = torch.arange(n, dtype=torch.float64)[:, None]
    j = torch.arange(d, dtype=torch.float64)[None]
    angle = pos / torch.pow(10000.0, 2 * torch.div(j, 2,
                                                   rounding_mode='floor') / d)
    angle[:, 0::2] = torch.sin(angle[:, 0::2])
    angle[:, 1::2] = torch.cos(angle[:, 1::2])
    return angle.float().to(device)


class RefVMAE:
    def __init__(self, sd: Dict[str, torch.Tensor], v: Dict, prec=F32):
        self.sd = {k: t.float() for k, t in sd.items()}
        self.v = v
        self.prec = prec
        self.grid = v['img_size'] // v['patch_size']
        self.n0 = self.grid * self.grid
        dev = next(iter(self.sd.values())).device
        n = self.n0 * v['num_frames']
        self.pos_enc = sinusoid_table(n, v['encoder_embed_dim'], dev)
        self.pos_dec = sinusoid_table(n, v['decoder_embed_dim'], dev)

    # -- layers ---------------------------------------------------------
    def linear(self, x, w, b=None):
        y = self.prec.matmul(x, w.t())
        return y if b is None else y + b

    @staticmethod
    def ln(x, w, b):
        return F.layer_norm(x, (x.shape[-1],), w, b, 1e-6)

    def embed(self, frames: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] normalised -> [B, grid^2, E] patch tokens (the
        tubelet-1 patch embedding as a strided convolution)."""
        w = self.sd['encoder.patch_embed.proj.weight'][:, :, 0]
        p = self.v['patch_size']
        b = self.sd['encoder.patch_embed.proj.bias']
        t = self.prec.conv2d(frames, w, b, stride=p)
        return t.flatten(2).transpose(1, 2)

    def qkv(self, pre: str, x: torch.Tensor, heads: int):
        s = self.sd
        d = x.shape[-1]
        bias = torch.cat([s[f'{pre}.attn.q_bias'],
                          torch.zeros_like(s[f'{pre}.attn.q_bias']),
                          s[f'{pre}.attn.v_bias']])
        h = self.ln(x, s[f'{pre}.norm1.weight'], s[f'{pre}.norm1.bias'])
        qkv = self.linear(h, s[f'{pre}.attn.qkv.weight'], bias)
        b, n, _ = qkv.shape
        qkv = qkv.reshape(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        return q * (d // heads) ** -0.5, k, v

    def attend(self, q, panels: List[Tuple[torch.Tensor, torch.Tensor,
                                           float]]):
        """Softmax over the concatenated key panels (k, v, weight); a panel
        of batch 1 serves every row of q."""
        scores, values = [], []
        for k, v, weight in panels:
            sc = self.prec.matmul(q, k.transpose(-1, -2))
            if weight != 1.0:
                sc = sc + math.log(weight)
            scores.append(sc)
            values.append(v)
        p = torch.softmax(torch.cat(scores, dim=-1), dim=-1)
        out, i = 0, 0
        for v in values:
            n = v.shape[-2]
            out = out + self.prec.matmul(p[..., i:i + n], v)
            i += n
        return out

    def finish(self, pre: str, x, attn_out, gelu: str):
        s = self.sd
        b, h, n, dh = attn_out.shape
        o = attn_out.transpose(1, 2).reshape(b, n, h * dh)
        x = x + self.linear(o, s[f'{pre}.attn.proj.weight'],
                            s[f'{pre}.attn.proj.bias'])
        y = self.ln(x, s[f'{pre}.norm2.weight'], s[f'{pre}.norm2.bias'])
        y = self.linear(y, s[f'{pre}.mlp.fc1.weight'],
                        s[f'{pre}.mlp.fc1.bias'])
        y = F.gelu(y, approximate='tanh' if gelu == 'tanh' else 'none')
        return x + self.linear(y, s[f'{pre}.mlp.fc2.weight'],
                               s[f'{pre}.mlp.fc2.bias'])

    def pool(self, t: torch.Tensor, pool: int) -> torch.Tensor:
        """[B, H, grid^2, d] -> [B, H, (grid/pool)^2, d]: the mean of each
        pool x pool cell of the patch grid."""
        if pool == 1:
            return t
        b, h, _, d = t.shape
        g = self.grid
        t = t.reshape(b, h, g // pool, pool, g // pool, pool, d)
        return t.mean(dim=(3, 5)).reshape(b, h, (g // pool) ** 2, d)

    # -- the two passes -------------------------------------------------
    def prefix(self, frame0: torch.Tensor):
        """frame0 [1, 3, H, W] normalised -> per-layer (k, v) of the
        encoder and of the decoder over frame 0."""
        v, s = self.v, self.sd
        x = self.embed(frame0) + self.pos_enc[None, :self.n0]
        enc = []
        for i in range(v['encoder_depth']):
            pre = f'encoder.blocks.{i}'
            q, k, vv = self.qkv(pre, x, v['encoder_num_heads'])
            enc.append((k, vv))
            x = self.finish(pre, x, self.attend(q, [(k, vv, 1.0)]), 'erf')
        x = self.ln(x, s['encoder.norm.weight'], s['encoder.norm.bias'])
        z = self.linear(x, s['encoder_to_decoder.weight'])
        z = z + self.pos_dec[None, :self.n0]
        dec = []
        for i in range(v['decoder_depth']):
            pre = f'decoder.blocks.{i}'
            q, k, vv = self.qkv(pre, z, v['decoder_num_heads'])
            dec.append((k, vv))
            z = self.finish(pre, z, self.attend(q, [(k, vv, 1.0)]), 'erf')
        return enc, dec

    def frame1(self, cache, frames1: torch.Tensor, visible: torch.Tensor,
               prefix_pool: int, suffix_pool: int, gelu: str):
        """frames1 [B, 3, H, W] normalised; visible [B, n] frame-1 patch
        indices of each sample. Returns the head's output for every
        frame-1 patch, [B, grid^2, patch pixels]."""
        v, s = self.v, self.sd
        enc, dec = cache
        b, n0 = visible.shape[0], self.n0
        tok = self.embed(frames1)
        tok = torch.gather(tok, 1, visible[..., None].expand(
            -1, -1, tok.shape[-1]))
        x = tok + self.pos_enc[n0 + visible]
        for i in range(v['encoder_depth']):
            pre = f'encoder.blocks.{i}'
            q, k, vv = self.qkv(pre, x, v['encoder_num_heads'])
            k0, v0 = enc[i]
            x = self.finish(pre, x, self.attend(
                q, [(k0, v0, 1.0), (k, vv, 1.0)]), gelu)
        x = self.ln(x, s['encoder.norm.weight'], s['encoder.norm.bias'])
        zv = self.linear(x, s['encoder_to_decoder.weight'])
        cd = zv.shape[-1]
        z = (s['mask_token'].reshape(1, 1, cd)
             + self.pos_dec[None, n0:]).repeat(b, 1, 1)
        z.scatter_(1, visible[..., None].expand(-1, -1, cd),
                   zv + self.pos_dec[n0 + visible])
        w0, w1 = float(prefix_pool ** 2), float(suffix_pool ** 2)
        for i in range(v['decoder_depth']):
            pre = f'decoder.blocks.{i}'
            q, k, vv = self.qkv(pre, z, v['decoder_num_heads'])
            k0, v0 = dec[i]
            panels = [(self.pool(k0, prefix_pool), self.pool(v0, prefix_pool),
                       w0),
                      (self.pool(k, suffix_pool), self.pool(vv, suffix_pool),
                       w1)]
            z = self.finish(pre, z, self.attend(q, panels), gelu)
        z = self.ln(z, s['decoder.norm.weight'], s['decoder.norm.bias'])
        return self.linear(z, s['decoder.head.weight'], s['decoder.head.bias'])


def patches_to_frame(patches: torch.Tensor, v: Dict) -> torch.Tensor:
    """[B, grid^2, p*p*3] (pixel layout (py, px, c)) -> [B, 3, H, W]."""
    b = patches.shape[0]
    p, g = v['patch_size'], v['img_size'] // v['patch_size']
    x = patches.reshape(b, g, g, p, p, 3).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(b, 3, g * p, g * p)
