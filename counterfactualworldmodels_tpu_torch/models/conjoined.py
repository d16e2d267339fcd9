"""Conjoined (two-stream) VMAE: an RGB stream and a context stream (flow or
IMU) coupled by cross-attention blocks.

Port of counterfactualworldmodels_tpu/models/conjoined.py. The streams are
the port's VMAE encoders/decoders (models/vmae.py; an IMU context stream
uses ``ImuEncoder``); cross blocks (models/transformer.py) sit BEFORE the
paired encoder layer and AFTER the paired decoder layer. Null-token
padding is the JAX package's static-shape scheme: each padded stream gets
``max_padding_tokens`` learnable null tokens, enough of them marked
visible per row that every row has exactly ``n_vis`` visible entries, and
the outputs at null positions are zeroed.

``ConjoinedVMAE`` is an ``nn.Module`` with the reference
Conjoined(Padded)PretrainVisionTransformer state-dict layout
(``main_stream.*``, ``context_stream.*``,
``{encoder,decoder}_conjoining_blocks.{i}-{j}.*``), so a released
checkpoint or the JAX package's parameters bridged by
``utils/weights.conjoined_state_dict_from_jax`` load with strict=True. Its
blocks' self-attention runs ``attn_impl``: 'flash' (the default here, and
the factories') launches K1 on the card and runs its plain version on the
CPU. ``ConjoinedPredictorWrapper`` runs the stream preprocessors
(models/preprocessor.py), computes the static visible counts and applies
the module without gradients.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..ops.pos_embed import sinusoid_encoding_table
from .layers import Block, LayerNorm, dense
from .transformer import CrossAttentionTransformerBlock
from .vmae import (PretrainVisionTransformer, VMAEDecoder, VMAEEncoder,
                   mask_order, take_tokens)


class _ImuPatchEmbed(nn.Module):
    """Tubelet embedding of a [B, C, L] stream: the reference's Conv3d
    (kernel (pt, 1, 1), weight [E, C, pt, 1, 1]) as one matmul on
    (pt, c)-ordered patch vectors."""

    def __init__(self, in_chans: int, embed_dim: int, tubelet: int, dtype,
                 device):
        super().__init__()
        self.proj = nn.Conv3d(in_chans, embed_dim, (tubelet, 1, 1),
                              stride=(tubelet, 1, 1), device=device)
        self.dtype = dtype

    def forward(self, patches):
        w = self.proj.weight[..., 0, 0]                   # [E, C, pt]
        kernel = w.permute(0, 2, 1).reshape(w.shape[0], -1)
        out = torch.nn.functional.linear(patches.to(self.dtype),
                                         kernel.to(self.dtype))
        return out + self.proj.bias.to(self.dtype)


class ImuEncoder(nn.Module):
    """IMU stream encoder: [B, C=6, L, 1, 1] pseudo-video in tubelet
    patches of ``tubelet_size`` samples, with an optional learnable,
    always-visible dummy token."""

    def __init__(self, sequence_length: int = 400, tubelet_size: int = 16,
                 in_chans: int = 6, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, concat_dummy_token: bool = True,
                 dtype=torch.float32, attn_impl: str = 'flash', device=None):
        super().__init__()
        self.sequence_length = sequence_length
        self.tubelet_size = tubelet_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.concat_dummy_token = concat_dummy_token
        self.dtype = dtype
        self.patch_embed = _ImuPatchEmbed(in_chans, embed_dim, tubelet_size,
                                          dtype, device)
        if concat_dummy_token:
            self.dummy_token = nn.Parameter(torch.zeros(
                1, in_chans, tubelet_size, 1, 1, device=device))
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, dtype=dtype,
                  attn_impl=attn_impl, device=device)
            for _ in range(depth)])
        self.norm = LayerNorm(embed_dim, 1e-6, dtype, device)

    @property
    def num_tokens(self):
        return self.sequence_length // self.tubelet_size

    num_patches = num_tokens

    @property
    def total_tokens(self):
        return self.num_tokens + int(self.concat_dummy_token)

    def append_dummy(self, imu, mask):
        """Concatenate the dummy token (always visible). imu: [B, C, L, 1, 1]
        or None (missing IMU: zeros, all masked but the dummy)."""
        b = mask.shape[0]
        if imu is None:
            imu = torch.zeros((b, self.in_chans, self.sequence_length, 1, 1),
                              device=mask.device)
            mask = torch.ones((b, self.num_tokens), dtype=torch.bool,
                              device=mask.device)
        if self.concat_dummy_token:
            dummy = self.dummy_token.to(imu.dtype).expand(
                b, self.in_chans, self.tubelet_size, 1, 1)
            imu = torch.cat([imu, dummy], dim=2)
            mask = torch.cat([mask, torch.zeros((b, 1), dtype=torch.bool,
                                                device=mask.device)], -1)
        return imu, mask

    def tokenize(self, imu):
        """[B, C, L(+pt), 1, 1] -> [B, L/pt(+1), E] with sincos positions."""
        b, c, l = imu.shape[:3]
        t = l // self.tubelet_size
        patches = imu.reshape(b, c, t, self.tubelet_size)
        patches = patches.movedim(1, -1).reshape(b, t, -1)
        tokens = self.patch_embed(patches)
        pos = sinusoid_encoding_table(t, self.embed_dim, device=imu.device)
        return tokens + pos.to(tokens.dtype)

    def forward(self, imu, mask, n_vis: int):
        tokens = self.tokenize(imu)
        x_vis = take_tokens(tokens, mask_order(mask)[:, :n_vis])
        for blk in self.blocks:
            x_vis = blk(x_vis)
        return self.norm(x_vis)


def pad_tokens_and_mask(tokens, mask, null_token, n_vis: int,
                        max_padding: int):
    """Append ``max_padding`` null tokens; per row the first
    (n_vis - row_visible) of them are marked visible, so every row has
    exactly ``n_vis`` visible entries. Returns (tokens_padded, full_mask)."""
    b, _, c = tokens.shape
    nulls = null_token.to(tokens.dtype).expand(b, max_padding, c)
    tokens_p = torch.cat([tokens, nulls], dim=1)
    pad_needed = n_vis - (~mask).sum(-1, keepdim=True)
    k = torch.arange(max_padding, device=mask.device)[None]
    return tokens_p, torch.cat([mask, k >= pad_needed], dim=-1)


class StreamSpec:
    """Static per-stream configuration shared by the encoder/decoder
    builders."""

    def __init__(self, *, is_imu=False, img_size=(224, 224), patch_size=(8, 8),
                 in_chans=3, num_frames=2, tubelet_size=1,
                 encoder_embed_dim=768, encoder_depth=12, encoder_num_heads=12,
                 decoder_embed_dim=384, decoder_depth=4, decoder_num_heads=6,
                 decoder_num_classes=None, mlp_ratio=4.0, qkv_bias=True,
                 sequence_length=400, imu_tubelet=16, concat_dummy_token=True,
                 padded=False, max_padding_tokens=0, min_padding_tokens=0):
        self.is_imu = is_imu
        self.img_size = tuple(img_size)
        self.patch_size = tuple(patch_size)
        self.in_chans = in_chans
        self.num_frames = num_frames
        self.tubelet_size = tubelet_size
        self.encoder_embed_dim = encoder_embed_dim
        self.encoder_depth = encoder_depth
        self.encoder_num_heads = encoder_num_heads
        self.decoder_embed_dim = decoder_embed_dim
        self.decoder_depth = decoder_depth
        self.decoder_num_heads = decoder_num_heads
        self.mlp_ratio = mlp_ratio
        self.qkv_bias = qkv_bias
        self.sequence_length = sequence_length
        self.imu_tubelet = imu_tubelet
        self.concat_dummy_token = concat_dummy_token
        self.padded = padded
        self.max_padding_tokens = max_padding_tokens
        self.min_padding_tokens = min_padding_tokens
        if decoder_num_classes is None:
            if is_imu:
                decoder_num_classes = in_chans * imu_tubelet
            else:
                decoder_num_classes = (in_chans * tubelet_size *
                                       patch_size[0] * patch_size[1])
        self.decoder_num_classes = decoder_num_classes

    @property
    def num_patches(self):
        if self.is_imu:
            return self.sequence_length // self.imu_tubelet
        h, w = self.img_size
        return ((h // self.patch_size[0]) * (w // self.patch_size[1]) *
                (self.num_frames // self.tubelet_size))

    @property
    def total_tokens(self):
        return self.num_patches + (int(self.concat_dummy_token)
                                   if self.is_imu else 0)

    def key(self):
        return tuple(sorted((k, str(v)) for k, v in self.__dict__.items()))

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, StreamSpec) and self.key() == other.key()

    def vmae_config(self, dtype, attn_impl) -> PretrainVisionTransformer:
        """The port's VMAE configuration of this stream's encoder/decoder."""
        return PretrainVisionTransformer(
            img_size=self.img_size, patch_size=self.patch_size,
            encoder_in_chans=self.in_chans,
            encoder_embed_dim=self.encoder_embed_dim,
            encoder_depth=self.encoder_depth,
            encoder_num_heads=self.encoder_num_heads,
            decoder_embed_dim=self.decoder_embed_dim,
            decoder_depth=self.decoder_depth,
            decoder_num_heads=self.decoder_num_heads,
            decoder_num_classes=self.decoder_num_classes,
            mlp_ratio=self.mlp_ratio, qkv_bias=self.qkv_bias,
            tubelet_size=self.tubelet_size, num_frames=self.num_frames,
            dtype=dtype, attn_impl=attn_impl)


class _Stream(nn.Module):
    """One stream's encoder, decoder, encoder-to-decoder projection, mask
    token and (padded) null tokens, under the reference's key names."""

    def __init__(self, spec: StreamSpec, dtype, attn_impl, device):
        super().__init__()
        cfg = spec.vmae_config(dtype, attn_impl)
        if spec.is_imu:
            self.encoder = ImuEncoder(
                spec.sequence_length, spec.imu_tubelet, spec.in_chans,
                spec.encoder_embed_dim, spec.encoder_depth,
                spec.encoder_num_heads, spec.mlp_ratio, spec.qkv_bias,
                spec.concat_dummy_token, dtype, attn_impl, device)
        else:
            self.encoder = VMAEEncoder(cfg, device)
        self.decoder = VMAEDecoder(cfg, device)
        self.encoder_to_decoder = nn.Linear(
            spec.encoder_embed_dim, spec.decoder_embed_dim, bias=False,
            device=device)
        self.mask_token = nn.Parameter(torch.zeros(
            1, 1, spec.decoder_embed_dim, device=device))
        if spec.padded:
            self.null_token_enc = nn.Parameter(torch.zeros(
                1, 1, spec.encoder_embed_dim, device=device))
            self.null_token_dec = nn.Parameter(torch.zeros(
                1, 1, spec.decoder_embed_dim, device=device))
        else:
            self.null_token_enc = self.null_token_dec = None


def _resolve_pairs(pairs, n_main: int, n_ctx: int, what: str):
    """Negative layer indices resolved mod the depths. The interleave only
    advances its layer counters, so the pairs must be unique with BOTH
    indices non-decreasing."""
    out = []
    for p in pairs:
        if not hasattr(p, '__len__'):
            p = (p, p)
        out.append((p[0] % n_main, p[1] % n_ctx))
    ok = all(b[0] >= a[0] and b[1] >= a[1] for a, b in zip(out, out[1:]))
    if not ok or len(set(out)) != len(out):
        raise ValueError(f'conjoin_{what}_layers must resolve to unique pairs '
                         f'with BOTH layer indices non-decreasing; got '
                         f'{tuple(out)}')
    return tuple(out)


class ConjoinedVMAE(nn.Module):
    """Two coupled masked predictors. forward(x, mask, x_context,
    mask_context, n_vis, n_vis_context, output_main, output_context): x
    [B,C,T,H,W]; mask bool [B, N_main]; x_context an image stream
    [B,Cc,Tc,H,W] or IMU [B,6,L,1,1] or None (missing IMU); mask_context
    bool [B, N_ctx] (before any dummy token). Returns the predictions of
    the masked tokens of the requested stream(s)."""

    def __init__(self, main: StreamSpec, context: StreamSpec,
                 conjoin_encoder_layers=((0, 0), (-1, -1)),
                 conjoin_decoder_layers=((0, 0),), cross_num_heads: int = 4,
                 cross_mlp_ratio: float = 2.0,
                 shared_similarity: bool = False,
                 with_self_attention: bool = False, dtype=torch.float32,
                 attn_impl: str = 'flash', device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.main, self.context = main, context
        self.conjoin_encoder_layers = tuple(conjoin_encoder_layers)
        self.conjoin_decoder_layers = tuple(conjoin_decoder_layers)
        self.cross_num_heads = cross_num_heads
        self.shared_similarity = shared_similarity
        self.with_self_attention = with_self_attention
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.main_stream = _Stream(main, dtype, attn_impl, device)
        self.context_stream = _Stream(context, dtype, attn_impl, device)
        self.enc_pairs = _resolve_pairs(self.conjoin_encoder_layers,
                                        main.encoder_depth,
                                        context.encoder_depth, 'encoder')
        self.dec_pairs = _resolve_pairs(self.conjoin_decoder_layers,
                                        main.decoder_depth,
                                        context.decoder_depth, 'decoder')

        def cross(i, j):
            return CrossAttentionTransformerBlock(
                in_dim=i, in_dim_src=j, num_heads=cross_num_heads,
                mlp_ratio=cross_mlp_ratio,
                shared_similarity=shared_similarity,
                with_self_attention=with_self_attention, dtype=dtype,
                device=device)

        self.encoder_conjoining_blocks = nn.ModuleDict({
            f'{i}-{j}': cross(main.encoder_embed_dim,
                              context.encoder_embed_dim)
            for i, j in self.enc_pairs})
        self.decoder_conjoining_blocks = nn.ModuleDict({
            f'{i}-{j}': cross(main.decoder_embed_dim,
                              context.decoder_embed_dim)
            for i, j in self.dec_pairs})

    @property
    def device(self):
        return self.main_stream.mask_token.device

    def encoder_cross_blocks(self):
        return [self.encoder_conjoining_blocks[f'{i}-{j}']
                for i, j in self.enc_pairs]

    def decoder_cross_blocks(self):
        return [self.decoder_conjoining_blocks[f'{i}-{j}']
                for i, j in self.dec_pairs]

    # ------------------------------------------------------------------
    def _tokenize_main(self, x, mask, n_vis):
        st = self.main_stream
        tokens = st.encoder.tokenize(x)
        if self.main.padded:
            tokens, mask = pad_tokens_and_mask(
                tokens, mask, st.null_token_enc, n_vis,
                self.main.max_padding_tokens)
        order = mask_order(mask)
        return take_tokens(tokens, order[:, :n_vis]), mask, order

    def _tokenize_context(self, x_c, mask_c, n_vis_c):
        st = self.context_stream
        if self.context.is_imu:
            x_c, mask_c = st.encoder.append_dummy(x_c, mask_c)
        tokens = st.encoder.tokenize(x_c)
        if self.context.padded:
            tokens, mask_c = pad_tokens_and_mask(
                tokens, mask_c, st.null_token_enc, n_vis_c,
                self.context.max_padding_tokens)
        order = mask_order(mask_c)
        return take_tokens(tokens, order[:, :n_vis_c]), mask_c, order

    def _encode(self, x_vis, x_vis_c):
        """Cross block BEFORE its paired encoder layer."""
        me, ce = self.main_stream.encoder, self.context_stream.encoder
        i = j = 0
        for (pi, pj), blk in zip(self.enc_pairs, self.encoder_cross_blocks()):
            while i < pi:
                x_vis = me.blocks[i](x_vis)
                i += 1
            while j < pj:
                x_vis_c = ce.blocks[j](x_vis_c)
                j += 1
            x_vis, x_vis_c = blk(x_vis, x_vis_c)
        for k in range(i, self.main.encoder_depth):
            x_vis = me.blocks[k](x_vis)
        for k in range(j, self.context.encoder_depth):
            x_vis_c = ce.blocks[k](x_vis_c)
        return me.norm(x_vis), ce.norm(x_vis_c)

    def _decode(self, x, x_c, n_mask_m, n_mask_c, output_main,
                output_context):
        """Cross block AFTER its paired decoder layer."""
        md, cd = self.main_stream.decoder, self.context_stream.decoder
        i = j = 0
        for (pi, pj), blk in zip(self.dec_pairs, self.decoder_cross_blocks()):
            while i <= pi:
                x = md.blocks[i](x)
                i += 1
            while j <= pj:
                x_c = cd.blocks[j](x_c)
                j += 1
            x, x_c = blk(x, x_c)
        for k in range(i, self.main.decoder_depth):
            x = md.blocks[k](x)
        for k in range(j, self.context.decoder_depth):
            x_c = cd.blocks[k](x_c)
        if output_main:
            x = md.get_last_tokens(x, n_mask_m)
        if output_context:
            x_c = cd.get_last_tokens(x_c, n_mask_c)
        return x, x_c

    def _dec_pos(self, spec, stream, order, n_vis, n_total):
        dim = spec.decoder_embed_dim
        b = order.shape[0]
        pos = sinusoid_encoding_table(spec.total_tokens, dim,
                                      device=order.device)
        pos = pos.expand(b, spec.total_tokens, dim)
        if spec.padded:
            nulls = stream.null_token_dec.expand(b, spec.max_padding_tokens,
                                                 dim)
            pos = torch.cat([pos, nulls], dim=1)
        # the table must cover the (padded) mask the order came from
        if pos.shape[1] != n_total:
            raise ValueError(f'position table of {pos.shape[1]} rows for a '
                             f'mask of {n_total}')
        pos = pos.to(self.dtype)
        return (take_tokens(pos, order[:, :n_vis]),
                take_tokens(pos, order[:, n_vis:]))

    def forward(self, x, mask, x_context, mask_context, n_vis: int,
                n_vis_context: int, output_main: bool = True,
                output_context: bool = False):
        ms, cs = self.main_stream, self.context_stream
        x_vis, full_mask_m, order_m = self._tokenize_main(x, mask, n_vis)
        x_vis_c, full_mask_c, order_c = self._tokenize_context(
            x_context, mask_context, n_vis_context)
        x_vis, x_vis_c = self._encode(x_vis, x_vis_c)
        x_vis = dense(x_vis, ms.encoder_to_decoder, self.dtype)
        x_vis_c = dense(x_vis_c, cs.encoder_to_decoder, self.dtype)
        pos_vis_m, pos_mask_m = self._dec_pos(self.main, ms, order_m, n_vis,
                                              full_mask_m.shape[-1])
        pos_vis_c, pos_mask_c = self._dec_pos(self.context, cs, order_c,
                                              n_vis_context,
                                              full_mask_c.shape[-1])
        x_full = torch.cat([x_vis + pos_vis_m,
                            ms.mask_token.to(x_vis.dtype) + pos_mask_m], 1)
        x_full_c = torch.cat([x_vis_c + pos_vis_c,
                              cs.mask_token.to(x_vis_c.dtype) + pos_mask_c],
                             1)
        y, y_c = self._decode(x_full, x_full_c, pos_mask_m.shape[1],
                              pos_mask_c.shape[1], output_main,
                              output_context)
        # zero the outputs at null (padding) positions
        if self.main.padded and output_main:
            is_null = order_m[:, n_vis:] >= self.main.total_tokens
            y = y * (~is_null)[..., None].to(y.dtype)
        if self.context.padded and output_context:
            is_null_c = order_c[:, n_vis_context:] >= self.context.total_tokens
            y_c = y_c * (~is_null_c)[..., None].to(y_c.dtype)
        if output_main and output_context:
            return y, y_c
        if output_main:
            return y
        if output_context:
            return y_c
        return y, y_c


# ---------------------------------------------------------------------------
# Factories of the released configurations
# ---------------------------------------------------------------------------

def imu400_base_4x4patch_2frames_1tube(dtype=torch.float32,
                                       attn_impl='flash', device='cuda'):
    """The IMU-conditioned ViT-B 4x4 predictor (checkpoint
    cwm_IMUcond_conjVMAE_224px_4x4patches_2frames.pth); both streams
    padded with null tokens."""
    main = StreamSpec(
        img_size=(224, 224), patch_size=(4, 4), in_chans=3, num_frames=2,
        encoder_embed_dim=768, encoder_depth=12, encoder_num_heads=12,
        decoder_embed_dim=384, decoder_depth=4, decoder_num_heads=6,
        padded=True, max_padding_tokens=64)
    context = StreamSpec(
        is_imu=True, in_chans=6, sequence_length=400, imu_tubelet=16,
        encoder_embed_dim=384, encoder_depth=12, encoder_num_heads=12,
        decoder_embed_dim=192, decoder_depth=4, decoder_num_heads=6,
        decoder_num_classes=96, concat_dummy_token=False,
        padded=True, max_padding_tokens=25)
    return ConjoinedVMAE(
        main=main, context=context,
        conjoin_encoder_layers=tuple((i, i) for i in range(0, 12, 3)),
        conjoin_decoder_layers=tuple((i, i) for i in range(4)),
        dtype=dtype, attn_impl=attn_impl, device=device)


def imu400_8x8patch_2frames_1tube_flowbackrgb01(dtype=torch.float32,
                                                attn_impl='flash',
                                                device='cuda'):
    """flow2imu: the main stream reads forward + backward RAFT flow and
    RGB (7 channels, 1 frame), the context stream is IMU; it predicts IMU
    from video (checkpoint flow2imu_conjVMAE_224px.pth)."""
    main = StreamSpec(
        img_size=(224, 224), patch_size=(8, 8), in_chans=7, num_frames=1,
        encoder_embed_dim=768, encoder_depth=12, encoder_num_heads=12,
        decoder_embed_dim=384, decoder_depth=4, decoder_num_heads=6,
        decoder_num_classes=448)
    context = StreamSpec(
        is_imu=True, in_chans=6, sequence_length=400, imu_tubelet=16,
        encoder_embed_dim=384, encoder_depth=12, encoder_num_heads=12,
        decoder_embed_dim=192, decoder_depth=4, decoder_num_heads=6,
        decoder_num_classes=96, concat_dummy_token=True)
    return ConjoinedVMAE(
        main=main, context=context,
        conjoin_encoder_layers=((0, 0), (-1, -1)),
        conjoin_decoder_layers=tuple((i, i) for i in range(4)),
        dtype=dtype, attn_impl=attn_impl, device=device)


def load_conjoined_checkpoint(path: str):
    """A reference conjoined .pth (``{'model': ...}`` or a bare state dict,
    DDP ``module.`` prefixes stripped) as a state dict of tensors. There is
    nothing to convert: the layout is the module's own."""
    from ..pipelines.prediction import strip_prefixes
    sd = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(sd, dict) and 'model' in sd:
        sd = sd['model']
    return {k: torch.as_tensor(v) for k, v in strip_prefixes(sd).items()}


class ConjoinedPredictorWrapper:
    """Runs the stream preprocessors and computes the static visible
    counts, then applies the ConjoinedVMAE module (which carries its
    weights). params: a reference-layout state dict, or load_path a .pth,
    loaded into the module with strict=True; with neither the module keeps
    its own weights."""

    def __init__(self, model: ConjoinedVMAE, params=None,
                 load_path: Optional[str] = None, main_input='rgb01',
                 main_input_kwargs=None, context_input='imu',
                 context_input_kwargs=None, num_frames=2):
        from .preprocessor import get_preprocessor
        self.model = model.eval()
        if params is None and load_path is not None:
            params = load_conjoined_checkpoint(load_path)
        self.params = None
        self.load_params(params)
        main_input_kwargs = dict(main_input_kwargs or {})
        context_input_kwargs = dict(context_input_kwargs or {})
        for kw in (main_input_kwargs, context_input_kwargs):
            kw.setdefault('device', self.device)
        self.get_main_input = (
            get_preprocessor(main_input, **main_input_kwargs)
            if isinstance(main_input, str) else main_input)
        self.get_context_input = (
            get_preprocessor(context_input, **context_input_kwargs)
            if isinstance(context_input, str) else context_input)
        self.num_frames = num_frames

    def load_params(self, params):
        """Load a state dict with strict=True (None keeps the module's own
        weights); ``params`` identifies the weights to the engines built
        from them."""
        if params is not None:
            self.model.load_state_dict(params, strict=True)
        self.params = (params if params is not None
                       else dict(self.model.state_dict()))

    @property
    def device(self):
        return self.model.device

    @property
    def main(self):
        return self.model.main

    @property
    def context(self):
        return self.model.context

    @property
    def patch_size(self):
        m = self.model.main
        return (m.tubelet_size,) + m.patch_size

    full_patch_size = patch_size

    @property
    def img_size(self):
        return self.model.main.img_size

    image_size = img_size

    @property
    def mask_size(self):
        m = self.model.main
        return (self.num_frames // m.tubelet_size,
                m.img_size[0] // m.patch_size[0],
                m.img_size[1] // m.patch_size[1])

    @property
    def num_patches(self):
        return int(np.prod(self.mask_size))

    @property
    def num_head_tokens(self):
        return self.model.context.num_patches

    def get_stream_inputs(self, x, mask, x_context=None, mask_context=None):
        """Each stream's input and mask. For an IMU context stream, no
        x_context is the missing-IMU regime (zeros, fully masked); an IMU
        x_context needs its mask_context (an IMU mask cannot come from the
        RGB mask)."""
        b = x.shape[0]
        t = self.num_frames
        ctx = self.model.context
        if ctx.is_imu:
            if x_context is None:
                x_context = torch.zeros((b, ctx.in_chans,
                                         ctx.sequence_length),
                                        device=x.device)
                if mask_context is None:
                    mask_context = torch.ones((b, ctx.num_patches),
                                              dtype=torch.bool,
                                              device=x.device)
            elif mask_context is None:
                raise ValueError(
                    'mask_context is required with an IMU x_context: the '
                    f'{ctx.num_patches}-token IMU mask cannot be derived '
                    'from the RGB mask')
        x_m = self.get_main_input(x)
        x_c = self.get_context_input(
            x_context if x_context is not None else x)
        mask = torch.as_tensor(mask, device=x.device)
        m3 = mask.reshape(b, t, -1)
        mask_m = self.get_main_input.get_output_frames(
            m3, temporal_dim=1).reshape(b, -1)
        if mask_context is None:
            mask_c = self.get_context_input.get_output_frames(
                m3, temporal_dim=1).reshape(b, -1)
        else:
            mask_c = torch.as_tensor(mask_context, device=x.device)
            nf_c = self.get_context_input.get_num_frames()
            if nf_c not in (0, None):
                mask_c = self.get_context_input.get_output_frames(
                    mask_c.reshape(b, t, -1), temporal_dim=1).reshape(b, -1)
        return (x_m, mask_m), (x_c, mask_c)

    def _static_n_vis(self, mask, spec):
        """The static visible count of a stream's masks (read on the host).
        A padded stream pads each row to the widest; a spread its null
        budget cannot cover raises, as does an unequal non-padded
        stream."""
        vis_rows = (~torch.as_tensor(mask)).sum(-1).cpu()
        vis, lo = int(vis_rows.max()), int(vis_rows.min())
        if spec.padded:
            spread = vis - lo
            if spread + spec.min_padding_tokens > spec.max_padding_tokens:
                raise ValueError(
                    f'per-row visible-count spread {spread} + '
                    f'min_padding_tokens {spec.min_padding_tokens} exceeds '
                    f'max_padding_tokens {spec.max_padding_tokens}; '
                    'rectangularize the masks or raise max_padding_tokens')
            # an all-masked padded stream still exposes one null token
            return max(vis + spec.min_padding_tokens, 1)
        if lo != vis:
            raise ValueError(
                'non-padded stream requires equal per-row visible counts, '
                f'got {sorted(set(vis_rows.tolist()))}; rectangularize the '
                'masks or use a padded StreamSpec')
        return vis

    def context_n_vis(self, mask_context):
        """The context stream's visible count, the dummy token included."""
        ctx = self.model.context
        n = self._static_n_vis(mask_context, ctx)
        return n + 1 if ctx.is_imu and ctx.concat_dummy_token else n

    def strip_padding(self, y):
        """Drop the trailing padded outputs."""
        m = self.model.main
        if not m.padded:
            return y
        num_pad = m.max_padding_tokens - m.min_padding_tokens
        if num_pad == 0:
            return y     # y[:, :-0] would drop every prediction
        return y[:, :-num_pad]

    @torch.no_grad()
    def __call__(self, x, mask, timestamps=None, x_context=None,
                 mask_context=None, output_main=True, output_context=False,
                 **kwargs):
        if timestamps is not None:
            raise NotImplementedError(
                'timestamp-conditioned position embeddings are not '
                'implemented')
        (x_m, mask_m), (x_c, mask_c) = self.get_stream_inputs(
            x, mask, x_context, mask_context)
        n_vis = self._static_n_vis(mask_m, self.model.main)
        return self.model(x_m, mask_m, x_c, mask_c, n_vis,
                          self.context_n_vis(mask_c), bool(output_main),
                          bool(output_context))

