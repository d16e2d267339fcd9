"""Plain IMU-conditioned conjoined VMAE for counterfactual prompts.

The model is the Counterfactual World Models conjoined predictor
(cwm/models/VideoMAE/conjoined_vmae.py: ConjoinedPaddedVisionTransformer,
ImuEncoder, CrossAttentionTransformerBlock): two VideoMAE streams, the
video (main) and the IMU (context), each with its own encoder and decoder
of pre-norm blocks (q and v biases, exact GELU, sinusoid positions), joined
by bidirectional cross blocks that sit BEFORE their paired encoder layers
and AFTER their paired decoder layers. A cross block without
self-attention normalises both streams, projects each to per-head
(query, key) pairs of the main stream's head width and to values; each main
token reads a softmax over the context tokens and each context token a
softmax over the main tokens (a separate similarity per direction, the
scale d^-1/2 on the main side), each stream adds its read through its own
projection and then its own MLP (GenericMlp: linear, exact GELU, linear).
The IMU stream is 6 channels in tubelets of ``imu_tubelet`` samples (the
reference's Conv3d with a (pt, 1, 1) kernel), plus an always-visible
dummy token where the configuration has one. A padded stream's decoder
also holds ``max_padding_tokens`` masked null rows (the mask token plus
the stream's null decoder token), which attend and are attended to like
any row; every prompt here shows the same number of tokens, so no null
token is ever visible.

A counterfactual prompt shows all of frame 0, a few frame-1 patches and
the whole IMU clip. This reference computes the shared-prefix
factorisation, written out from its definition:

- frame 0's main tokens run once per scene through both streams' encoders
  and decoders, coupled to the scene's own context stream; every main
  block keeps its keys and values, every cross block the frame-0 rows'
  keys and values of the context <- main direction;
- each sample's visible frame-1 tokens run through the main encoder
  attending to [frame 0's keys of that layer ; their own keys];
- each sample's context stream is recomputed from the IMU tokens: at each
  cross block it reads the softmax over [frame 0's cached keys ; the
  sample's own main keys], and the sample's main tokens read it;
- each sample's frame-1 rows (visible tokens and mask tokens) and the main
  stream's null rows run through the decoder against [frame 0's keys ;
  their own] at full resolution (no pooling), with the sample's context
  decoder beside them, and the head predicts every frame-1 patch.

Departures from the published model: frame 0's tokens do not read the
frame-1 tokens or the per-sample context (the frozen prefix of the
program's engine); the decoder's frame-0 rows are not recomputed per
sample, so only frame-1 predictions are made. The main stream reads the
frames in [0, 1]: the predictor's rgb01 input unnormalises what the
generator ImageNet-normalised.

Every product runs through ``prec`` (float32, or the FP8 control); scores,
softmax, norms and sums are float32. No kernel, cache or batching of the
program is used. ``judge`` holds the program's videos and flows against
this reference and the plain RAFT with the numbers of reference/cf.py.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .cf import _gaps, _pixel_mask, _rel, prompt_video, raft_flows
from .precision import BF16, F32, FP8, f32_mode
from .raft import RAFT
from .vmae import RefVMAE, patches_to_frame, sinusoid_table

BLOCK = 8           # samples a reference pass holds


def layer_pairs(cfg: Dict, which: str) -> List[Tuple[int, int]]:
    """The cross blocks' (main layer, context layer) pairs of the encoder
    or the decoder, negative indices taken modulo the depths."""
    m, c = cfg['main'], cfg['context']
    depth = f'{which}_depth'
    return [(i % m[depth], j % c[depth])
            for i, j in cfg[f'conjoin_{which}_layers']]


class RefConjoined(RefVMAE):
    """The layers are RefVMAE's (qkv, attend, finish) under the conjoined
    state dict's block prefixes."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg: Dict, prec=F32):
        self.sd = {k: t.float() for k, t in sd.items()}
        self.prec = prec
        self.m, self.c = cfg['main'], cfg['context']
        self.heads = cfg['cross_num_heads']
        self.enc_pairs = layer_pairs(cfg, 'encoder')
        self.dec_pairs = layer_pairs(cfg, 'decoder')
        m, c = self.m, self.c
        self.grid = m['img_size'] // m['patch_size']
        self.n0 = self.grid * self.grid
        dev = next(iter(self.sd.values())).device
        n = self.n0 * m['num_frames']
        self.pos_enc = sinusoid_table(n, m['encoder_embed_dim'], dev)
        self.pos_dec = sinusoid_table(n, m['decoder_embed_dim'], dev)
        self.n_ctx = (c['sequence_length'] // c['imu_tubelet']
                      + int(c['concat_dummy_token']))
        self.pos_ctx_enc = sinusoid_table(self.n_ctx, c['encoder_embed_dim'],
                                          dev)
        self.pos_ctx_dec = sinusoid_table(self.n_ctx, c['decoder_embed_dim'],
                                          dev)

    # -- layers ---------------------------------------------------------
    def embed(self, frames: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] in [0, 1] -> [B, grid^2, E] main patch tokens."""
        w = self.sd['main_stream.encoder.patch_embed.proj.weight'][:, :, 0]
        b = self.sd['main_stream.encoder.patch_embed.proj.bias']
        t = self.prec.conv2d(frames, w, b, stride=self.m['patch_size'])
        return t.flatten(2).transpose(1, 2)

    def imu_tokens(self, clip: torch.Tensor) -> torch.Tensor:
        """clip [1, C, L] -> [1, n_ctx, Ec]: tubelets of pt samples through
        the Conv3d's (pt, 1, 1) kernel, with the dummy token appended where
        the configuration has one, plus the positions."""
        s, pre = self.sd, 'context_stream.encoder'
        if self.c['concat_dummy_token']:
            dummy = s[f'{pre}.dummy_token'][..., 0, 0]
            clip = torch.cat([clip.float(), dummy], dim=2)
        w = s[f'{pre}.patch_embed.proj.weight'][..., 0, 0]      # [E, C, pt]
        e, ch, pt = w.shape
        b, _, length = clip.shape
        x = clip.float().reshape(b, ch, length // pt, pt).transpose(1, 2)
        tok = self.linear(x.reshape(b, length // pt, ch * pt),
                          w.reshape(e, ch * pt),
                          s[f'{pre}.patch_embed.proj.bias'])
        return tok + self.pos_ctx_enc[None]

    def block(self, pre: str, x, heads: int, prefix_kv=None):
        """A pre-norm block; its keys attend [prefix_kv ; own] where given.
        Returns (x, (k, v))."""
        q, k, v = self.qkv(pre, x, heads)
        panels = [(k, v, 1.0)] if prefix_kv is None else [
            (prefix_kv[0], prefix_kv[1], 1.0), (k, v, 1.0)]
        return self.finish(pre, x, self.attend(q, panels), 'erf'), (k, v)

    def _heads(self, x, w, width):
        b, n, _ = x.shape
        y = self.linear(x, w)
        return y.reshape(b, n, self.heads, width).transpose(1, 2)

    def cross(self, pre: str, x, src, ckv=None):
        """The bidirectional cross block over main tokens x and context
        tokens src. The context reads [ckv (cached frame-0 keys, values) ;
        x's own] where ckv is given, x's alone otherwise. Returns (x, src,
        (the context-direction keys, the values) of x's tokens)."""
        s, ca = self.sd, f'{pre}.cross_attention'
        d = s[f'{ca}.v.weight'].shape[0] // self.heads
        scale = d ** -0.5
        lx = self.ln(x, s[f'{pre}.norm1_cross.weight'],
                     s[f'{pre}.norm1_cross.bias'])
        ls = self.ln(src, s[f'{pre}.norm1_src_cross.weight'],
                     s[f'{pre}.norm1_src_cross.bias'])
        qk = self._heads(lx, s[f'{ca}.qk.weight'], 2 * d)
        qk_src = self._heads(ls, s[f'{ca}.qk_src.weight'], 2 * d)
        v = self._heads(lx, s[f'{ca}.v.weight'], d)
        v_src = self._heads(ls, s[f'{ca}.v_src.weight'], d)
        # main <- context
        y = self.attend(qk[..., :d] * scale, [(qk_src[..., :d], v_src, 1.0)])
        # context <- main: the scale rides the main-side keys
        own = (qk[..., d:] * scale, v)
        panels = [(own[0], own[1], 1.0)] if ckv is None else [
            (ckv[0], ckv[1], 1.0), (own[0], own[1], 1.0)]
        y_src = self.attend(qk_src[..., d:], panels)

        def merge(t):
            b, h, n, w = t.shape
            return t.transpose(1, 2).reshape(b, n, h * w)

        x = x + self.linear(merge(y), s[f'{ca}.projection.weight'],
                            s[f'{ca}.projection.bias'])
        src = src + self.linear(merge(y_src), s[f'{ca}.projection_src.weight'],
                                s[f'{ca}.projection_src.bias'])
        x = x + self.mlp(f'{pre}.mlp.trg', self.ln(
            x, s[f'{pre}.norm2.weight'], s[f'{pre}.norm2.bias']))
        src = src + self.mlp(f'{pre}.mlp.src', self.ln(
            src, s[f'{pre}.norm2_src.weight'], s[f'{pre}.norm2_src.bias']))
        return x, src, own

    def mlp(self, pre: str, x):
        s = self.sd
        h = self.linear(x, s[f'{pre}.layers.0.weight'],
                        s[f'{pre}.layers.0.bias'])
        return self.linear(torch.nn.functional.gelu(h),
                           s[f'{pre}.layers.2.weight'],
                           s[f'{pre}.layers.2.bias'])

    def ctx_decoder_rows(self, ctx):
        """The context decoder's rows: the encoded context projected, with
        its positions, then the null rows of a padded stream."""
        s, c = self.sd, self.c
        z = self.linear(ctx, s['context_stream.encoder_to_decoder.weight'])
        z = z + self.pos_ctx_dec[None]
        if c['padded'] and c['max_padding_tokens']:
            null = (s['context_stream.mask_token']
                    + s['context_stream.null_token_dec'])
            z = torch.cat([z, null.expand(z.shape[0], c['max_padding_tokens'],
                                          -1)], dim=1)
        return z

    # -- the two passes -------------------------------------------------
    def _encoder(self, h, ctx, enc_kv=None, enc_ckv=None):
        """Both encoders, interleaved: returns (h, ctx, main (k, v) per
        layer, the cross blocks' frame-main (k, v))."""
        m, c = self.m, self.c
        kvs, ckvs = [], []
        i = j = 0
        for n, (pi, pj) in enumerate(self.enc_pairs):
            while i < pi:
                h, kv = self.block(f'main_stream.encoder.blocks.{i}', h,
                                   m['encoder_num_heads'],
                                   None if enc_kv is None else enc_kv[i])
                kvs.append(kv)
                i += 1
            while j < pj:
                ctx = self.block(f'context_stream.encoder.blocks.{j}', ctx,
                                 c['encoder_num_heads'])[0]
                j += 1
            h, ctx, ckv = self.cross(f'encoder_conjoining_blocks.{pi}-{pj}',
                                     h, ctx,
                                     None if enc_ckv is None else enc_ckv[n])
            ckvs.append(ckv)
        for k in range(i, m['encoder_depth']):
            h, kv = self.block(f'main_stream.encoder.blocks.{k}', h,
                               m['encoder_num_heads'],
                               None if enc_kv is None else enc_kv[k])
            kvs.append(kv)
        for k in range(j, c['encoder_depth']):
            ctx = self.block(f'context_stream.encoder.blocks.{k}', ctx,
                             c['encoder_num_heads'])[0]
        s = self.sd
        h = self.ln(h, s['main_stream.encoder.norm.weight'],
                    s['main_stream.encoder.norm.bias'])
        ctx = self.ln(ctx, s['context_stream.encoder.norm.weight'],
                      s['context_stream.encoder.norm.bias'])
        return h, ctx, kvs, ckvs

    def _decoder(self, z, zc, dec_kv=None, dec_ckv=None):
        m, c = self.m, self.c
        kvs, ckvs = [], []
        i = j = 0
        for n, (pi, pj) in enumerate(self.dec_pairs):
            while i <= pi:
                z, kv = self.block(f'main_stream.decoder.blocks.{i}', z,
                                   m['decoder_num_heads'],
                                   None if dec_kv is None else dec_kv[i])
                kvs.append(kv)
                i += 1
            while j <= pj:
                zc = self.block(f'context_stream.decoder.blocks.{j}', zc,
                                c['decoder_num_heads'])[0]
                j += 1
            z, zc, ckv = self.cross(f'decoder_conjoining_blocks.{pi}-{pj}',
                                    z, zc,
                                    None if dec_ckv is None else dec_ckv[n])
            ckvs.append(ckv)
        for k in range(i, m['decoder_depth']):
            z, kv = self.block(f'main_stream.decoder.blocks.{k}', z,
                               m['decoder_num_heads'],
                               None if dec_kv is None else dec_kv[k])
            kvs.append(kv)
        return z, kvs, ckvs

    def prefix(self, frame0: torch.Tensor, clip: torch.Tensor) -> Dict:
        """frame0 [1, 3, H, W] in [0, 1], clip [1, C, L] -> what every
        sample reads of the scene: the IMU tokens, each main block's
        (k, v) and each cross block's frame-0 (k, v), per encoder and
        decoder."""
        s = self.sd
        ctx0 = self.imu_tokens(clip)
        h = self.embed(frame0) + self.pos_enc[None, :self.n0]
        h, ctx, enc_kv, enc_ckv = self._encoder(h, ctx0)
        z = self.linear(h, s['main_stream.encoder_to_decoder.weight'])
        z = z + self.pos_dec[None, :self.n0]
        _, dec_kv, dec_ckv = self._decoder(z, self.ctx_decoder_rows(ctx))
        return {'ctx0': ctx0, 'enc_kv': enc_kv, 'enc_ckv': enc_ckv,
                'dec_kv': dec_kv, 'dec_ckv': dec_ckv}

    def frame1(self, cache: Dict, frames1: torch.Tensor,
               visible: torch.Tensor) -> torch.Tensor:
        """frames1 [B, 3, H, W] in [0, 1]; visible [B, n] frame-1 patch
        indices of each sample. Returns the head's output for every frame-1
        patch, [B, grid^2, patch pixels]."""
        m, s = self.m, self.sd
        b, n0 = visible.shape[0], self.n0
        tok = self.embed(frames1)
        tok = torch.gather(tok, 1, visible[..., None].expand(
            -1, -1, tok.shape[-1]))
        x = tok + self.pos_enc[n0 + visible]
        ctx = cache['ctx0'].expand(b, -1, -1)
        x, ctx, _, _ = self._encoder(x, ctx, cache['enc_kv'],
                                     cache['enc_ckv'])
        zv = self.linear(x, s['main_stream.encoder_to_decoder.weight'])
        cd = zv.shape[-1]
        mask_token = s['main_stream.mask_token'].reshape(1, 1, cd)
        z = (mask_token + self.pos_dec[None, n0:]).repeat(b, 1, 1)
        z.scatter_(1, visible[..., None].expand(-1, -1, cd),
                   zv + self.pos_dec[n0 + visible])
        if m['padded'] and m['max_padding_tokens']:
            null = mask_token + s['main_stream.null_token_dec']
            z = torch.cat([z, null.expand(b, m['max_padding_tokens'], -1)],
                          dim=1)
        z, _, _ = self._decoder(z, self.ctx_decoder_rows(ctx),
                                cache['dec_kv'], cache['dec_ckv'])
        z = self.ln(z[:, :n0], s['main_stream.decoder.norm.weight'],
                    s['main_stream.decoder.norm.bias'])
        return self.linear(z, s['main_stream.decoder.head.weight'],
                           s['main_stream.decoder.head.bias'])


def predicted_videos(ref: RefConjoined, scene, clip, video, visible,
                     masked) -> torch.Tensor:
    """The reference's output video: the input where it is shown, the
    prediction at the masked frame-1 patches."""
    m = ref.m
    cache = ref.prefix(scene[None], clip)
    out = []
    for i in range(0, video.shape[0], BLOCK):
        sl = slice(i, i + BLOCK)
        pred = ref.frame1(cache, video[sl, 1], visible[sl])
        f1 = torch.where(_pixel_mask(masked[sl], m),
                         patches_to_frame(pred, m), video[sl, 1])
        out.append(torch.stack([video[sl, 0], f1], dim=1))
    return torch.cat(out)


def build(cfg: Dict, sd, sd_raft, prec=F32) -> Tuple[RefConjoined, RAFT]:
    r = cfg['raft']
    raft = RAFT(r['corr_levels'], r['corr_radius'], r['iters'])
    raft.load_state_dict(sd_raft, strict=True)
    raft = raft.to(next(iter(sd_raft.values())).device).eval()
    return RefConjoined(sd, cfg, prec), raft.set_precision(prec)


@torch.no_grad()
def judge(cfg: Dict, sd, sd_raft, prompts, clip, video_p, flow_p
          ) -> Dict[str, float]:
    """prompts: (scene, active, passive, shifts) of the judged rows; clip
    [1, C, L] the call's IMU; video_p [R, 2, 3, H, W] and flow_p
    [R, 2, H, W] the program's. The numbers of reference/cf.py's judge."""
    m = cfg['main']
    with f32_mode():
        ref, raft = build(cfg, sd, sd_raft)
        scene, active, passive, shifts = prompts
        video, visible, masked = prompt_video(scene, active, passive,
                                              shifts, m)
        video_r = predicted_videos(ref, scene, clip, video, visible, masked)
        shown = torch.ones_like(video_r[:, :, :1], dtype=torch.bool)
        shown[:, 1] = ~_pixel_mask(masked, m)
        copy_gap = ((video_p.float() - video.float()).abs()
                    * shown).amax()
        pm = _pixel_mask(masked, m).float()
        pred = _rel(video_p[:, 1], video_r[:, 1], pm)
        flow_rr = raft_flows(raft, video_r)
        num, den = _gaps(raft_flows(raft.set_precision(BF16), video_r),
                         flow_rr)
        unit = max(float(num.norm() / den.norm()), 1e-12)
        raft.set_precision(F32)
        flow = _rel(flow_p, raft_flows(raft, video_p)) / unit
        flow_full = _rel(flow_p, flow_rr) / unit
    return {'pred_rel_err': pred, 'flow_gap_bf16x': flow,
            'flow_full_gap_bf16x': flow_full, 'copy_max_abs': float(copy_gap)}


@torch.no_grad()
def control_outputs(cfg: Dict, sd, sd_raft, prompts, clip):
    """(video, flow) of the reference in float8 on the judged prompts."""
    with f32_mode():
        ref, raft = build(cfg, sd, sd_raft, FP8)
        scene, active, passive, shifts = prompts
        video, visible, masked = prompt_video(scene, active, passive,
                                              shifts, cfg['main'])
        video_c = predicted_videos(ref, scene, clip, video, visible, masked)
        return video_c, raft_flows(raft, video_c)
