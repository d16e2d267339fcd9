"""HTTP serving for counterfactual world models on the GPU.

Port of the JAX package's serving script (``scripts/serve.py``): a small
stdlib-only server over the port's generators, with the same flags,
endpoints and JSON schema:

    GET  /health          -> {"status": "ok", "backend": "cuda"}
    GET  /stats           -> engine, requests, prefix-cache and batching
                             counters
    POST /predict         -> factual prediction
    POST /counterfactual  -> counterfactual simulation + flow + segment
    POST /movability      -> movability map (--imu-conditioned only)

Request JSON (the POSTs):
    {"image": [[...]] float [H, W, 3] in [0, 1] (or nested list [3, H, W]),
     "active": [[row, col], ...]   frame-1 patch-grid coordinates,
     "passive": [[row, col], ...]  optional static patches,
     "shift": [dy, dx]             patch-unit shift (counterfactual only),
     "num_samples": int            optional, counterfactual only,
     "iters": int                  optional, movability only}

Responses return base64 PNGs ("prediction", and for counterfactuals
"simulation", "flow_rgb" and "segment") plus the raw segment as a nested
list. ``/health``'s backend is the torch device type the generator runs on:
'cuda', or 'cpu' when ``--device cpu`` asks for it.

Requests are handled on threads; device work is serialised by the
service's lock, and every dispatch runs under ``torch.no_grad()`` (grad
mode is per thread in PyTorch). Concurrent counterfactuals that share a
visible-patch count merge into one dispatch (``utils/batching``): on one
scene along the sample axis, on different scenes over stacked per-sample
prefix caches. Unlike the JAX script, a failure of the fast engine is not
masked by a fall back to the exact engine: it reaches the client as a 500
and the engine label stays. Routing on the engine's preconditions happens
before it runs, in the generators.

Usage:
    python -m counterfactualworldmodels_tpu_torch.serve --model large \\
        --warmup
    curl -s localhost:8731/health
"""
from __future__ import annotations

import argparse
import base64
import collections
import hashlib
import json
import struct
import threading
import time
import traceback
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ._device import resolve_device
from .models import fast_conjoined, fast_vmae
from .ops.flow_viz import flow_to_rgb
from .ops.resize import resize_bilinear
from .pipelines.imu import _imu_counterfactual_multi_step_fast
from .pipelines.segmentation import (
    counterfactual_videos_and_flows_fast,
    counterfactual_videos_and_flows_fast_multi)
from .utils.batching import MicroBatcher, pad_to_bucket


def _weights_generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def build_generator(args, device='cuda'):
    """The FlowGenerator the server runs (tiny / base / large), on
    ``device`` (bf16 on the card, f32 on the CPU). Weights: ``args.params``
    and ``args.raft_params`` (reference ``.pth`` checkpoints) or seeded
    random ones. On the card the kernels are built first."""
    from .models import vmae
    from .models.raft.raft import RAFT
    from .pipelines.prediction import (load_raft_checkpoint,
                                       load_vmae_checkpoint)
    from .pipelines.segmentation import FlowGenerator
    from .utils import weights
    from .utils.cache import enable_persistent_cache
    dev = resolve_device(device)
    if dev.type == 'cuda':
        enable_persistent_cache()
    dtype = torch.bfloat16 if dev.type == 'cuda' else torch.float32
    if args.model == 'tiny':
        model = vmae.PretrainVisionTransformer(
            img_size=(args.img_size, args.img_size), patch_size=(8, 8),
            encoder_embed_dim=96, encoder_depth=2, encoder_num_heads=2,
            decoder_embed_dim=64, decoder_depth=1, decoder_num_heads=2,
            mlp_ratio=2.0, qkv_bias=True, num_frames=2, tubelet_size=1,
            dtype=dtype)
    elif args.model == 'base':
        model = vmae.base_8x8patch_2frames_1tube(dtype=dtype)
    else:
        model = vmae.large_4x4patch_2frames_1tube(dtype=dtype)
    params = (load_vmae_checkpoint(args.params) if args.params else
              weights.init_vmae_state_dict(model, _weights_generator(dev, 0)))
    raft = RAFT(iters=args.raft_iters, dtype=dtype, device=dev)
    if args.raft_params:
        raft.load_state_dict(load_raft_checkpoint(args.raft_params),
                             strict=True)
    else:
        weights.init_raft(raft, _weights_generator(dev, 1))
    # engine and prefix_cache_size flow into the generator so its own fast
    # routes (the per-click predict and its LRU) engage too
    return FlowGenerator(predictor=model, params=params, flow_model=raft,
                         raft_iters=args.raft_iters,
                         imagenet_normalize_inputs=True, seed=args.seed,
                         engine=getattr(args, 'engine', 'fast'),
                         prefix_cache_size=getattr(args, 'prefix_cache_size',
                                                   4),
                         device=dev)


def imu_movability_generator(predictor, head_motion_predictor, raft, args,
                             device='cuda'):
    """The ImuConditionedMovabilityPredictor the IMU server runs, over the
    IMU-conditioned predictor and flow2imu (ConjoinedPredictorWrapper
    each) and the RAFT probe, with the server's movability settings."""
    from .pipelines.movability import (
        make_imu_conditioned_movability_predictor)
    cls = make_imu_conditioned_movability_predictor()
    return cls(predictor=predictor,
               head_motion_predictor=head_motion_predictor,
               flow_model=raft, raft_iters=args.raft_iters,
               imagenet_normalize_inputs=True, seed=args.seed,
               engine=args.engine,
               prefix_cache_size=getattr(args, 'prefix_cache_size', 4),
               initialize_from_keypoints=False,
               num_initial_samples=args.movability_samples,
               num_samples_per_iteration=args.movability_samples,
               num_iters=args.movability_iters,
               sample_batch_size=args.movability_samples,
               device=device)


def build_imu_generator(args, device='cuda'):
    """The IMU-conditioned movability predictor (the flagship demo's
    composition): the imu400 conjoined predictor and the flow2imu
    head-motion model, so /counterfactual and /movability both work; the
    'fast' engine runs the conjoined shared-prefix engine. Weights:
    ``args.params`` / ``args.flow2imu_params`` / ``args.raft_params``
    (reference ``.pth`` checkpoints) or seeded random ones."""
    from .models import conjoined as conj
    from .models.raft.raft import RAFT
    from .pipelines.prediction import load_raft_checkpoint
    from .utils import weights
    from .utils.cache import enable_persistent_cache
    dev = resolve_device(device)
    if dev.type == 'cuda':
        enable_persistent_cache()
    dtype = torch.bfloat16 if dev.type == 'cuda' else torch.float32
    raft = RAFT(iters=args.raft_iters, dtype=dtype, device=dev)
    if args.raft_params:
        raft.load_state_dict(load_raft_checkpoint(args.raft_params),
                             strict=True)
    else:
        weights.init_raft(raft, _weights_generator(dev, 1))

    if args.model == 'tiny':
        sz = args.img_size
        ctx = conj.StreamSpec(
            is_imu=True, in_chans=6, sequence_length=48, imu_tubelet=8,
            encoder_embed_dim=32, encoder_depth=2, encoder_num_heads=4,
            decoder_embed_dim=24, decoder_depth=2, decoder_num_heads=4,
            decoder_num_classes=48, mlp_ratio=2.0, concat_dummy_token=False,
            padded=True, max_padding_tokens=6)
        main = conj.StreamSpec(
            img_size=(sz, sz), patch_size=(8, 8), in_chans=3, num_frames=2,
            encoder_embed_dim=48, encoder_depth=2, encoder_num_heads=4,
            decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=4,
            mlp_ratio=2.0, padded=True, max_padding_tokens=8)
        pairs = dict(conjoin_encoder_layers=((0, 0), (-1, -1)),
                     conjoin_decoder_layers=((0, 0), (1, 1)))
        imu_cond = conj.ConjoinedVMAE(main=main, context=ctx, dtype=dtype,
                                      device=dev, **pairs)
        f2i_ctx = conj.StreamSpec(
            is_imu=True, in_chans=6, sequence_length=48, imu_tubelet=8,
            encoder_embed_dim=32, encoder_depth=2, encoder_num_heads=4,
            decoder_embed_dim=24, decoder_depth=2, decoder_num_heads=4,
            decoder_num_classes=48, mlp_ratio=2.0, concat_dummy_token=True)
        f2i_main = conj.StreamSpec(
            img_size=(sz, sz), patch_size=(8, 8), in_chans=7, num_frames=1,
            encoder_embed_dim=48, encoder_depth=2, encoder_num_heads=4,
            decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=4,
            mlp_ratio=2.0, decoder_num_classes=448)
        flow2imu = conj.ConjoinedVMAE(main=f2i_main, context=f2i_ctx,
                                      dtype=dtype, device=dev, **pairs)
    else:
        if args.img_size != 224:
            raise ValueError('--imu-conditioned base/large requires '
                             '--img-size 224 (the released imu400 config)')
        imu_cond = conj.imu400_base_4x4patch_2frames_1tube(dtype=dtype,
                                                           device=dev)
        flow2imu = conj.imu400_8x8patch_2frames_1tube_flowbackrgb01(
            dtype=dtype, device=dev)

    def load_or_init(model, path, seed):
        if path:
            return conj.load_conjoined_checkpoint(path)
        return weights.init_conjoined_state_dict(
            model, _weights_generator(dev, seed))

    imu_cond_w = conj.ConjoinedPredictorWrapper(
        imu_cond, params=load_or_init(imu_cond, args.params, 0),
        main_input='rgb01', context_input='imu')
    flow2imu_w = conj.ConjoinedPredictorWrapper(
        flow2imu, params=load_or_init(flow2imu, args.flow2imu_params, 2),
        main_input='flowback_rgb01',
        main_input_kwargs={'unnormalize': True, 'iters': args.raft_iters,
                           'flow_model': raft},
        context_input='imu')
    return imu_movability_generator(imu_cond_w, flow2imu_w, raft, args, dev)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit PNG of a uint8 image: [H, W] grey or [H, W, 3] RGB, every
    row with filter 0 (none), zlib-compressed, no interlace."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[-1] != 3):
        raise ValueError(f'expected uint8 [H, W] or [H, W, 3]: '
                         f'{img.dtype} {img.shape}')
    h, w = img.shape[:2]
    colour = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack('>IIBBBBB', w, h, 8, colour, 0, 0, 0)
    return (b'\x89PNG\r\n\x1a\n' + _png_chunk(b'IHDR', header)
            + _png_chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b'IEND', b''))


def _png_b64(arr):
    """[H, W, 3] or [H, W] float array in [0, 1] -> base64 PNG (RGB; a
    grey image is repeated on three channels, as the JAX script does)."""
    a = np.asarray(arr)
    if a.ndim == 2:
        a = np.stack([a] * 3, -1)
    return base64.b64encode(
        encode_png((np.clip(a, 0, 1) * 255).astype(np.uint8))).decode()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _same_images(items) -> bool:
    x0 = items[0][0]
    return all(it[0].shape == x0.shape and bool(torch.equal(it[0], x0))
               for it in items[1:])


class CwmService:
    """The serving surface over a FlowGenerator: /predict through the
    generator's own per-click route and prefix LRU; /counterfactual through
    the service's shared-prefix dispatches and its own prefix LRU
    (engine 'fast'), or the generator's API (engine 'exact')."""

    def __init__(self, G, img_size, engine='fast', prefix_cache_size=4,
                 seed=0, batch_window_ms=5.0, max_batch_samples=64,
                 max_scene_batch=8):
        if engine not in ('fast', 'exact'):
            raise ValueError(f'engine must be "fast" or "exact": {engine!r}')
        self.G = G
        self.device = resolve_device(G.device)
        self.img_size = img_size
        self.engine = engine
        self.lock = threading.Lock()
        self.seed = seed
        self._req_counter = 0
        # fast_vmae.PrefixLru: repeat requests on the same image (the
        # interactive probing workload) skip the frame-0 prefix pass
        self._fp = None
        self._lru = None
        self.prefix_cache_size = prefix_cache_size
        # micro-batch concurrent counterfactuals into one dispatch; weight
        # = the request's sample count, so max_batch_samples caps SAMPLES
        # per merged dispatch
        self._batcher = None
        self.max_batch_samples = int(max_batch_samples)
        if batch_window_ms > 0:
            self._batcher = MicroBatcher(self._dispatch_cf_batch,
                                         window_s=batch_window_ms / 1e3,
                                         max_items=self.max_batch_samples,
                                         weight=lambda item: item[4])
        # powers of two up to the sample cap, plus the cap itself: every
        # legal s_total (<= max_batch_samples) pads UP to a bucket
        self._s_buckets = self._pow2_buckets(self.max_batch_samples)
        # mixed-scene dispatches stack one prefix KV set PER SAMPLE -> cap
        # their batch separately
        self.max_scene_batch = int(max_scene_batch)
        self.scene_batches = 0      # mixed-scene dispatches run

    @staticmethod
    def _pow2_buckets(cap):
        """(1, 2, 4, ..., cap): cap included even when not a power of two,
        so padding never clamps below a legal batch size."""
        b, v = {1, int(cap)}, 1
        while v < cap:
            v *= 2
            b.add(min(v, int(cap)))
        return tuple(sorted(b))

    def _scene_buckets(self):
        """Pad buckets for MIXED-scene dispatches: the powers of two below
        the cap, plus the cap itself (mixed chunks never exceed
        max_scene_batch samples)."""
        return sorted({b for b in self._s_buckets
                       if b < self.max_scene_batch}
                      | {self.max_scene_batch})

    @property
    def prefix_hits(self):
        return self._lru.hits if self._lru else 0

    @property
    def prefix_misses(self):
        return self._lru.misses if self._lru else 0

    def _draw_noise(self, s_total, s_pad, n):
        """The rectangularizer's uniform [0, 0.999) draws [s_pad, n] of a
        dispatch: s_total rows from a Generator seeded with seed + the
        request counter, then the last row repeated, so the pad bucket
        never changes the real samples' draws."""
        g = torch.Generator(device=self.device).manual_seed(
            self.seed + self._req_counter)
        noise = torch.rand(s_total, n, generator=g, device=self.device)
        noise = noise * 0.999
        if s_pad > s_total:
            noise = torch.cat([noise, noise[-1:].expand(s_pad - s_total, n)])
        return noise

    def _prefix_for(self, x):
        """x: [1, C, H, W] in [0, 1]. Returns (cache, hit: bool)."""
        if self._lru is None:
            G = self.G
            self._fp = fast_vmae.stack_vmae_params(G.predictor, G.params,
                                                   device=self.device)
            self._lru = fast_vmae.PrefixLru(
                G.predictor, self._fp, self.device.type == 'cuda',
                G.imagenet_normalize_inputs, size=self.prefix_cache_size)
        return self._lru.get(x)

    def _parse_image(self, req):
        """The request's image as [1, 3, S, S] on the device (resized as
        the JAX script's jax.image.resize(..., 'bilinear') does)."""
        img = np.asarray(req['image'], np.float32)
        if img.ndim != 3:
            raise ValueError(f'image must be rank 3, got {img.shape}')
        if img.shape[-1] == 3:                     # HWC -> CHW
            img = img.transpose(2, 0, 1)
        if img.shape[0] != 3:
            raise ValueError(f'image must have 3 channels, got {img.shape}')
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        return resize_bilinear(x, (self.img_size, self.img_size))[None]

    def _patch_mask(self, coords, grid, n):
        mask = np.ones((1, n), dtype=bool)
        mask[0, :n // 2] = False
        for r, c_ in (coords or []):
            mask[0, n // 2 + (int(r) % grid) * grid + (int(c_) % grid)] = \
                False
        return mask

    def predict(self, req):
        x = self._parse_image(req)
        G = self.G
        n = G.predictor.num_patches
        grid = G.mask_shape[-1]
        mask = torch.from_numpy(self._patch_mask(req.get('active'), grid, n))
        with self.lock, torch.no_grad():
            video = x[:, None].expand(1, 2, *x.shape[1:])
            pred = G.predict(video, mask.to(self.device), frame=1)
            pred = _host(pred[0, 0]).transpose(1, 2, 0)
        return {'prediction': _png_b64(pred)}

    def _parse_cf_request(self, req):
        """Request parsing for both engines. Returns (x [1,C,H,W], active
        [1,N] np.bool_, passive [1,N] np.bool_, shift [dy,dx],
        num_samples). Patch masks follow the library convention: True =
        masked, the *visible* entries are the prompt patches; frame 0 is
        always visible."""
        x = self._parse_image(req)
        if not req.get('active'):
            raise ValueError('counterfactual requires "active" patches')
        n = self.G.predictor.num_patches
        grid = self.G.mask_shape[-1]
        active = self._patch_mask(req.get('active'), grid, n)
        passive = self._patch_mask(req.get('passive'), grid, n)
        s = int(req.get('num_samples', 1))
        if not 1 <= s <= self.max_batch_samples:
            # over-cap requests would exceed every bucket (and the
            # per-dispatch memory budget); the cap is the documented contract
            raise ValueError(f'num_samples must be in '
                             f'[1, {self.max_batch_samples}], got {s}')
        shift = [int(v) for v in req.get('shift', [0, 2])]
        if len(shift) != 2:
            raise ValueError(f'shift must be [dy, dx], got {shift}')
        return (x, active, passive, shift, s)

    def _cf_response(self, sim, flow0, seg, **extra):
        """Response assembly: simulation/flow/segment PNGs + the raw
        segment. flow0 [2, H, W] and seg [H, W] tensors."""
        flow0 = flow0.float()
        rgb = _host(flow_to_rgb(
            flow0, max_speed=max(float(flow0.abs().max()), 1e-3))
        ).transpose(1, 2, 0)
        seg = _host(seg)
        return {'simulation': _png_b64(sim), 'flow_rgb': _png_b64(rgb),
                'segment': _png_b64(seg),
                'segment_raw': np.round(seg, 4).tolist(), **extra}

    def _responses(self, ys, flows, counts, **extra):
        """One response per request of a dispatch: its first sample's
        simulation and flow, and the motion map of its samples."""
        out, off = [], 0
        for s in counts:
            fl = flows[off:off + s]               # [s, 1, 2, H, W]
            flows_s = fl[:, 0].movedim(0, -1)[None]
            seg = self.G.compute_mean_motion_map(flows_s)[0, 0]
            out.append(self._cf_response(
                _host(ys[off, 1]).transpose(1, 2, 0), fl[0, 0], seg,
                **extra))
            off += s
        return out

    def _counterfactual_fast(self, parsed):
        """The shared-prefix route: concurrent requests sharing n_vis are
        micro-batched (same scene along the S axis, different scenes over
        stacked per-sample prefix caches)."""
        x, active_np, passive_np, shift, s = parsed
        # visible = union of the two prompt sets (the exact route's
        # _n_vis_target; a sum would double-count patches in both)
        n_vis = int((~(active_np & passive_np)).sum())
        item = (x, active_np, passive_np, shift, s)
        if self._batcher is None:
            return self._dispatch_cf_batch((None, n_vis), [item])[0]
        return self._batcher.run(('cf', n_vis), item)

    def _dispatch_cf_batch(self, key, items):
        """Route a closed batch: all-same-image -> the shared-prefix
        S-dispatch; mixed images -> multi-scene chunks capped at
        max_scene_batch samples each (stacked caches are per-sample)."""
        _, n_vis = key
        if _same_images(items):
            return self._dispatch_same_scene(n_vis, items)
        out, chunk, cnt = [], [], 0
        for it in items:
            s = it[4]
            if chunk and cnt + s > self.max_scene_batch:
                out.extend(self._dispatch_chunk(n_vis, chunk))
                chunk, cnt = [], 0
            chunk.append(it)
            cnt += s
        if chunk:
            out.extend(self._dispatch_chunk(n_vis, chunk))
        return out

    def _dispatch_chunk(self, n_vis, items):
        if len(items) == 1 or _same_images(items):
            return self._dispatch_same_scene(n_vis, items)
        return self._dispatch_multi_scene(n_vis, items)

    def _sfx_pad(self, n_vis):
        """The bucketed suffix width of a dispatch (fast_vmae.sfx_bucket)."""
        n0 = self.G.predictor.num_patches_per_frame
        return fast_vmae.sfx_bucket(n_vis - n0,
                                    self.G.predictor.num_patches - n0)

    def _rows(self, items, s_pad):
        """Per-sample (x, active, passive, shift) rows of a mixed-scene
        batch, padded to s_pad by repeating the last; returns (rows,
        active [S,N], passive [S,N], shifts [S,2]) on the device."""
        s_total = sum(it[4] for it in items)
        if s_pad < s_total:
            raise RuntimeError(f'pad bucket {s_pad} < {s_total} samples')
        rows = []
        for (x, a, p, shift, s) in items:
            rows.extend([(x, a[0], p[0], shift)] * s)
        rows.extend([rows[-1]] * (s_pad - s_total))
        dev = self.device
        act = torch.from_numpy(np.stack([r[1] for r in rows])).to(dev)
        pas = torch.from_numpy(np.stack([r[2] for r in rows])).to(dev)
        shf = torch.tensor([r[3] for r in rows], dtype=torch.long,
                           device=dev)
        return rows, act, pas, shf

    def _dispatch_multi_scene(self, n_vis, items):
        """ONE dispatch for concurrent prompts on DIFFERENT images:
        per-sample scenes and stacked per-sample prefix caches (sample i
        attends scene i's own prefix: K2 with s0 = S)."""
        G = self.G
        counts = [it[4] for it in items]
        s_total = sum(counts)
        s_pad = pad_to_bucket(s_total, self._scene_buckets())
        rows, act, pas, shf = self._rows(items, s_pad)
        use_flash = self.device.type == 'cuda'
        with self.lock, torch.no_grad():
            self._req_counter += 1
            n0 = G.predictor.num_patches_per_frame
            noise = self._draw_noise(s_total, s_pad,
                                     G.predictor.num_patches - n0)
            # one LRU probe per distinct request, expanded to its samples
            caches, hits = [], []
            for (x_i, *_r), s in zip(items, counts):
                c, h = self._prefix_for(x_i)
                caches.extend([c] * s)
                hits.extend([h] * s)
            caches.extend([caches[-1]] * (s_pad - s_total))
            hits.extend([hits[-1]] * (s_pad - s_total))
            stacked = fast_vmae.stack_prefix_caches(caches)
            xs = torch.cat([r[0][:, None].expand(1, 2, *r[0].shape[1:])
                            for r in rows])
            ys, flows, _ = counterfactual_videos_and_flows_fast_multi(
                G.predictor, self._fp, G.flow_model, xs, pas, act, shf,
                self._sfx_pad(n_vis), G.imagenet_normalize_inputs,
                G.raft_iters, True, use_flash,
                fast_vmae.resolve_two_source(use_flash), noise, stacked,
                n_vis=n_vis, device=self.device)
            self.scene_batches += 1
            out, off = [], 0
            for s, resp in zip(counts, self._responses(
                    ys, flows, counts, engine='fast', batched_samples=s_pad,
                    scene_batched=len(items))):
                out.append(dict(resp, prefix_cache_hit=hits[off]))
                off += s
        return out

    def _stacked_prompts(self, items, s_pad):
        """Same-scene items' prompt columns concatenated along S and padded
        to s_pad by repeating the last column: (active [1,N,S], passive
        [1,N,S], shifts [S][2])."""
        s_total = sum(it[4] for it in items)
        if s_pad < s_total:
            raise RuntimeError(f'pad bucket {s_pad} < {s_total} samples')
        act = np.concatenate([np.repeat(a[..., None], s, axis=-1)
                              for (_, a, _, _, s) in items], axis=-1)
        pas = np.concatenate([np.repeat(p[..., None], s, axis=-1)
                              for (_, _, p, _, s) in items], axis=-1)
        shifts = []
        for (_, _, _, shift, s) in items:
            shifts.extend([list(shift)] * s)
        if s_pad > s_total:                      # repeat the last column
            act = np.concatenate(
                [act, np.repeat(act[..., -1:], s_pad - s_total, -1)], -1)
            pas = np.concatenate(
                [pas, np.repeat(pas[..., -1:], s_pad - s_total, -1)], -1)
            shifts.extend([shifts[-1]] * (s_pad - s_total))
        dev = self.device
        return (torch.from_numpy(act).to(dev), torch.from_numpy(pas).to(dev),
                shifts)

    def _dispatch_same_scene(self, n_vis, items):
        """One shared-prefix dispatch for a batch of same-scene requests;
        returns one response per item."""
        G = self.G
        x = items[0][0]
        counts = [it[4] for it in items]
        s_total = sum(counts)
        s_pad = (s_total if self._batcher is None
                 else pad_to_bucket(s_total, self._s_buckets))
        active, passive, shifts = self._stacked_prompts(items, s_pad)
        shifts = torch.tensor(shifts, dtype=torch.long,
                              device=self.device)[None]
        use_flash = self.device.type == 'cuda'
        with self.lock, torch.no_grad():
            self._req_counter += 1
            n0 = G.predictor.num_patches_per_frame
            noise = self._draw_noise(s_total, s_pad,
                                     G.predictor.num_patches - n0)
            cache, hit = self._prefix_for(x)
            video = x[:, None].expand(1, 2, *x.shape[1:])
            ys, flows, _ = counterfactual_videos_and_flows_fast(
                G.predictor, self._fp, G.flow_model, video, passive, active,
                shifts, noise, self._sfx_pad(n_vis),
                G.imagenet_normalize_inputs, G.raft_iters, True, use_flash,
                fast_vmae.resolve_two_source(use_flash), prefix_cache=cache,
                n_vis=n_vis)
            extra = ({} if self._batcher is None
                     else {'batched_samples': s_pad})
            return self._responses(ys, flows, counts, prefix_cache_hit=hit,
                                   engine='fast', **extra)

    def counterfactual(self, req):
        # parse and validate first: a malformed request is a 400
        parsed = self._parse_cf_request(req)
        if self.engine == 'fast':
            return self._counterfactual_fast(parsed)
        x, active, passive_np, shift, s = parsed
        G = self.G
        passive = (torch.from_numpy(passive_np).to(self.device)
                   if req.get('passive') else None)
        with self.lock, torch.no_grad():
            self._req_counter += 1
            ys, flows = G.predict_counterfactual_videos_and_flows(
                x, active_patches=torch.from_numpy(active).to(self.device),
                passive_patches=passive, shifts=[tuple(shift)] * s,
                num_samples=s, sample_batch_size=s)
            seg = G.compute_mean_motion_map(G._batch_to_samples(flows))[0, 0]
            return self._cf_response(_host(ys[0, 1]).transpose(1, 2, 0),
                                     flows[0, 0], seg)

    # ---- startup warmup ----

    def _snapshot_counters(self):
        b = self._batcher
        return {'req': self._req_counter, 'scene': self.scene_batches,
                'batches': b.batches if b else 0,
                'batched_items': b.batched_items if b else 0,
                # routes through the generator API advance its draws;
                # restore them so post-warmup requests draw as on a cold
                # server
                'g_state': self.G.generator.get_state()}

    def _restore_counters(self, s):
        self._req_counter = s['req']
        self.scene_batches = s['scene']
        if self._batcher is not None:
            self._batcher.batches = s['batches']
            self._batcher.batched_items = s['batched_items']
        self.G.generator.set_state(s['g_state'])

    def _clear_prefix_state(self):
        """Drop the synthetic warmup scenes from the prefix LRUs (the
        service's and the generator's own) and zero their counters."""
        lrus = [self._lru]
        lrus += [getattr(self.G, a, None)
                 for a in ('_prefix_lru', '_conj_prefix_lru')]
        for lru in lrus:
            if lru is not None:
                with lru._lock:
                    lru._entries.clear()
                    lru.hits = lru.misses = 0

    def _mixed_warm_ready(self):
        return True

    def _warm_mixed_dispatch(self, n_vis, items):
        return self._dispatch_multi_scene(n_vis, items)

    def warmup(self, buckets=(1, 4, 16), active_counts=(1, 5, 9),
               log=print):
        """Run every serving route once before accepting traffic.

        One dispatch per (route, padded batch size) on synthetic scenes:
        /predict, the counterfactual dispatch at each S bucket in
        ``buckets`` and each prompt size in ``active_counts`` (one per
        suffix bucket of fast_vmae.sfx_bucket), and, on the fast engine
        with micro-batching, the mixed-scene dispatch at each scene bucket
        up to max(buckets). On the card this builds the kernels (if not
        built yet), loads them and touches every route; nothing compiles
        per shape. A failure raises: a kernel that cannot build or launch
        stops the server before it binds its port.

        Service counters and the generator's draws are restored and the
        prefix caches cleared afterwards, so requests then compute what
        they would on an un-warmed server. Returns [(route, batch_size,
        seconds), ...].
        """
        g = self.img_size
        yy, xx = np.meshgrid(np.linspace(0., 1., g, dtype=np.float32),
                             np.linspace(0., 1., g, dtype=np.float32),
                             indexing='ij')

        def synth(i):
            base = (yy * (i + 1) + xx) % 1.0
            return np.stack([base, 0.25 + 0.5 * base, 1.0 - base],
                            -1).round(3).tolist()

        saved = self._snapshot_counters()
        warmed = []

        def run(route, batch, fn):
            if log:
                log(f'warmup {route} batch={batch}...')
            t0 = time.perf_counter()
            fn()
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            warmed.append((route, int(batch), round(dt, 3)))
            if log:
                log(f'warmup {route} batch={batch}: {dt:.1f}s')

        img0 = synth(0)
        run('predict', 1,
            lambda: self.predict({'image': img0, 'active': [[0, 0]]}))
        for b in buckets:
            for k in active_counts:
                # distinct patch coords (duplicates would shrink the
                # union count below k and warm the wrong bucket)
                req = {'image': img0,
                       'active': [[j // 4, j % 4] for j in range(int(k))],
                       'shift': [0, 1], 'num_samples': int(b)}
                run(f'counterfactual[{self.engine}]', b,
                    lambda req=req: self.counterfactual(dict(req)))
        if (self.engine == 'fast' and self._batcher is not None
                and self._mixed_warm_ready()):
            # mixed-scene dispatches only arise from >= 2 merged items
            for sb in [s for s in self._scene_buckets()
                       if 2 <= s <= max(max(buckets), 2)]:
                items = []
                for i in range(int(sb)):
                    x, a, p, shift, _ = self._parse_cf_request(
                        {'image': synth(i), 'active': [[1, 2]],
                         'shift': [0, 1], 'num_samples': 1})
                    items.append((x, a, p, shift, 1))
                n_vis = int((~(items[0][1] & items[0][2])).sum())
                run('mixed-scene', sb,
                    lambda it=items, nv=n_vis:
                        self._warm_mixed_dispatch(nv, it))
        self._restore_counters(saved)
        self._clear_prefix_state()
        return warmed


class ImuCwmService(CwmService):
    """Serving surface over the IMU-conditioned movability predictor.

    /counterfactual routes through the generator API (with engine 'fast'
    the conjoined shared-prefix engine and its LRU engage inside
    pipelines/imu.py), or for concurrent requests on different scenes
    through stacked conjoined caches; /movability runs the full iterated
    sampling loop. The IMU context is the predicted static-scene
    embedding, cached per image."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._imu_cache = collections.OrderedDict()

    @property
    def prefix_hits(self):
        lru = self.G._conj_prefix_lru
        return lru.hits if lru else 0

    @property
    def prefix_misses(self):
        lru = self.G._conj_prefix_lru
        return lru.misses if lru else 0

    def _static_imu_for(self, x):
        """Image-keyed LRU (sha1 of the image, copied to the host once) of
        the predicted static-scene IMU: flow2imu is scene-constant, so
        repeat requests and every movability iteration skip it."""
        a = x.detach().cpu().numpy()
        key = hashlib.sha1(
            repr((a.shape, a.dtype.str)).encode() + a.tobytes()).hexdigest()
        if key in self._imu_cache:
            self._imu_cache.move_to_end(key)
            return self._imu_cache[key]
        video = x[:, None].expand(1, 2, *x.shape[1:])
        h = self.G.get_static_imu(video)
        self._imu_cache[key] = h
        if len(self._imu_cache) > self.prefix_cache_size:
            self._imu_cache.popitem(last=False)
        return h

    def _imu_n_vis(self, active, passive):
        """The generator's rectangularizer target for ONE prompt column
        (segmentation._n_vis_target): the batch key, so merged columns
        share the static visible count of their serial runs."""
        p, a = np.asarray(passive), np.asarray(active)
        npf = p.shape[1] // self.G.sequence_length
        vis_f0 = (~p[:, :npf] | ~a[:, :npf]).sum()
        vis_f1 = ((~p[:, npf:] & a[:, npf:]) | ~a[:, npf:]).sum()
        return int(vis_f0 + vis_f1)

    def _dispatch_cf_batch(self, key, items):
        """All-same-image batches take the public-API S-dispatch; mixed
        images merge over stacked conjoined caches (engine 'fast' on a
        model the engine supports), chunked under max_scene_batch, or else
        run per image in order."""
        _, n_vis = key
        if _same_images(items):
            return self._dispatch_imu_scene(items)
        if self.engine != 'fast' or not self._imu_fast_ready():
            out, group = [], [items[0]]
            for it in items[1:]:
                if _same_images([group[0], it]):
                    group.append(it)
                else:
                    out.extend(self._dispatch_imu_scene(group))
                    group = [it]
            out.extend(self._dispatch_imu_scene(group))
            return out
        out, chunk, cnt = [], [], 0
        for it in items:
            s = it[4]
            if chunk and cnt + s > self.max_scene_batch:
                out.extend(self._dispatch_imu_chunk(n_vis, chunk))
                chunk, cnt = [], 0
            chunk.append(it)
            cnt += s
        if chunk:
            out.extend(self._dispatch_imu_chunk(n_vis, chunk))
        return out

    def _imu_fast_ready(self):
        """True when the conjoined shared-prefix engine supports the model
        (fast_conjoined.conjoined_fast_supported)."""
        return fast_conjoined.conjoined_fast_supported(
            self.G.predictor.model)

    def _clear_prefix_state(self):
        super()._clear_prefix_state()
        self._imu_cache.clear()

    def _mixed_warm_ready(self):
        return self._imu_fast_ready()

    def _warm_mixed_dispatch(self, n_vis, items):
        return self._dispatch_imu_multi_scene(n_vis, items)

    def _dispatch_imu_chunk(self, n_vis, items):
        if len(items) == 1 or _same_images(items):
            return self._dispatch_imu_scene(items)
        return self._dispatch_imu_multi_scene(n_vis, items)

    def _dispatch_imu_multi_scene(self, n_vis, items):
        """ONE conjoined dispatch for concurrent IMU-conditioned prompts on
        DIFFERENT images: per-sample (scene, IMU) pairs and stacked
        conjoined caches; RAFT per sample."""
        G = self.G
        counts = [it[4] for it in items]
        s_total = sum(counts)
        s_pad = pad_to_bucket(s_total, self._scene_buckets())
        rows, act, pas, shf = self._rows(items, s_pad)
        with self.lock, torch.no_grad():
            self._req_counter += 1
            m = G.predictor.model.main
            n0 = m.num_patches // m.num_frames
            noise = self._draw_noise(s_total, s_pad, m.num_patches - n0)
            G._ensure_conj_fast()
            # one static-IMU and conjoined-LRU probe per distinct request,
            # expanded to its samples
            caches, ctxs = [], []
            for (x_i, *_r), s in zip(items, counts):
                video = x_i[:, None].expand(1, 2, *x_i.shape[1:])
                ctx = G.reshape_output(self._static_imu_for(x_i))
                cache, _ = G._conj_prefix_lru.get(video, ctx)
                caches.extend([cache] * s)
                ctxs.extend([ctx] * s)
            caches.extend([caches[-1]] * (s_pad - s_total))
            ctxs.extend([ctxs[-1]] * (s_pad - s_total))
            stacked = fast_conjoined.stack_conjoined_prefix_caches(caches)
            xs = torch.cat([r[0][:, None].expand(1, 2, *r[0].shape[1:])
                            for r in rows])
            x_context = torch.cat(ctxs)
            mask_context = torch.zeros((s_pad, G.num_head_tokens),
                                       dtype=torch.bool, device=self.device)
            ys, flows, _ = _imu_counterfactual_multi_step_fast(
                G.predictor, G._conj_params, G.flow_model, xs, pas, act, shf,
                noise, x_context, mask_context, n_vis,
                G.imagenet_normalize_inputs, G.raft_iters, G._use_flash,
                fast_conjoined.resolve_two_source(G._use_flash), stacked)
            self.scene_batches += 1
            return self._responses(ys, flows, counts, engine=self.engine,
                                   imu_conditioned=True,
                                   batched_samples=s_pad,
                                   scene_batched=len(items))

    def _dispatch_imu_scene(self, items):
        """One generator call for a batch of same-scene IMU-conditioned
        requests: prompt columns concatenate along the S axis of the
        public API, which routes through the conjoined shared-prefix
        engine and its LRU when engine='fast'."""
        G = self.G
        x = items[0][0]
        counts = [it[4] for it in items]
        s_total = sum(counts)
        s_pad = (s_total if self._batcher is None
                 else pad_to_bucket(s_total, self._s_buckets))
        act, pas, shifts = self._stacked_prompts(items, s_pad)
        with self.lock, torch.no_grad():
            self._req_counter += 1
            head = self._static_imu_for(x)
            ys, flows = G.predict_counterfactual_videos_and_flows(
                x, active_patches=act, passive_patches=pas,
                shifts=[tuple(s) for s in shifts], num_samples=s_pad,
                sample_batch_size=s_pad, head_motion=head)
            return self._responses(ys, flows, counts, engine=self.engine,
                                   imu_conditioned=True,
                                   batched_samples=s_pad)

    def counterfactual(self, req):
        # parse and validate first: a malformed request is a 400
        x, active, passive_np, shift, s = self._parse_cf_request(req)
        G = self.G
        if self._batcher is not None:
            item = (x, active, passive_np, shift, s)
            return self._batcher.run(
                ('imu', self._imu_n_vis(active, passive_np)), item)
        passive = (torch.from_numpy(passive_np).to(self.device)
                   if req.get('passive') else None)
        with self.lock, torch.no_grad():
            self._req_counter += 1
            head = self._static_imu_for(x)
            ys, flows = G.predict_counterfactual_videos_and_flows(
                x, active_patches=torch.from_numpy(active).to(self.device),
                passive_patches=passive, shifts=[tuple(shift)] * s,
                num_samples=s, sample_batch_size=s, head_motion=head)
            seg = G.compute_mean_motion_map(G._batch_to_samples(flows))[0, 0]
            return self._cf_response(
                _host(ys[0, 1]).transpose(1, 2, 0), flows[0, 0], seg,
                engine=self.engine, imu_conditioned=True)

    def movability(self, req):
        """{image, iters?} -> movability map (the iterated loop over
        IMU-conditioned counterfactuals, with the cached static IMU)."""
        x = self._parse_image(req)
        iters = req.get('iters')
        if iters is not None:
            iters = int(iters)
            if iters < 0:
                raise ValueError(f'iters must be >= 0, got {iters}')
        with self.lock, torch.no_grad():
            self._req_counter += 1
            head = self._static_imu_for(x)
            video = x[:, None].expand(1, 2, *x.shape[1:])
            out = self.G(video, head_motion=head, num_iters=iters)
            m = _host(out[0, 0])
        rng = float(m.max() - m.min())
        return {'movability': _png_b64((m - m.min()) / max(rng, 1e-6)),
                'movability_raw': np.round(m, 4).tolist(),
                'engine': self.engine}


def make_handler(service, backend):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            print('%s - %s' % (self.address_string(), fmt % a))

        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/health':
                self._send(200, {'status': 'ok', 'backend': backend})
            elif self.path == '/stats':
                b = service._batcher
                self._send(200, {
                    'engine': service.engine,
                    'requests': service._req_counter,
                    'prefix_cache': {'hits': service.prefix_hits,
                                     'misses': service.prefix_misses,
                                     'size': service.prefix_cache_size},
                    'micro_batching': (
                        None if b is None else
                        {'dispatches': b.batches,
                         'requests_batched': b.batched_items,
                         'scene_batches': service.scene_batches,
                         'window_ms': round(b.window_s * 1e3, 2)})})
            else:
                self._send(404, {'error': f'unknown path {self.path}'})

        def do_POST(self):
            try:
                length = int(self.headers.get('Content-Length', 0))
                req = json.loads(self.rfile.read(length) or b'{}')
            except ValueError as e:
                return self._send(400, {'error': f'bad JSON: {e}'})
            if not isinstance(req, dict):
                return self._send(400, {'error': 'the body must be a JSON '
                                                 'object'})
            try:
                if self.path == '/predict':
                    self._send(200, service.predict(req))
                elif self.path == '/counterfactual':
                    self._send(200, service.counterfactual(req))
                elif (self.path == '/movability'
                        and hasattr(service, 'movability')):
                    self._send(200, service.movability(req))
                else:
                    self._send(404, {'error': f'unknown path {self.path}'})
            except (ValueError, KeyError) as e:
                self._send(400, {'error': str(e)})
            except Exception as e:  # noqa: BLE001 - the request boundary
                # the server keeps running; the client sees the failure
                traceback.print_exc()
                self._send(500, {'error': f'{type(e).__name__}: {e}'})
    return Handler


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', default='base',
                    choices=['tiny', 'base', 'large'])
    ap.add_argument('--img-size', type=int, default=224)
    ap.add_argument('--device', default='cuda',
                    help='torch device; "cpu" runs the plain PyTorch path')
    ap.add_argument('--params', default=None,
                    help='reference .pth checkpoint of the predictor')
    ap.add_argument('--raft-params', default=None,
                    help='reference .pth checkpoint of RAFT')
    ap.add_argument('--raft-iters', type=int, default=24)
    ap.add_argument('--imu-conditioned', action='store_true',
                    help='serve the IMU-conditioned movability pipeline '
                         '(conjoined imu400 predictor + flow2imu '
                         'head-motion model); adds the /movability endpoint')
    ap.add_argument('--flow2imu-params', default=None,
                    help='reference .pth checkpoint of the flow2imu model '
                         '(--imu-conditioned only)')
    ap.add_argument('--movability-samples', type=int, default=16)
    ap.add_argument('--movability-iters', type=int, default=2)
    ap.add_argument('--port', type=int, default=8731)
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--prefix-cache-size', type=int, default=4,
                    help='prefix-cache LRU entries (each pins the per-layer '
                         'prefix KV of one image in device memory)')
    ap.add_argument('--batch-window-ms', type=float, default=5.0,
                    help='micro-batch window: concurrent counterfactual '
                         'requests sharing n_vis within this window merge '
                         'into one dispatch (same scene along the S axis, '
                         'mixed scenes over stacked per-sample prefix '
                         'caches); 0 disables')
    ap.add_argument('--max-batch-samples', type=int, default=64,
                    help='max total samples per micro-batched dispatch')
    ap.add_argument('--max-scene-batch', type=int, default=8,
                    help='max samples per MIXED-scene dispatch (each '
                         'sample pins its own prefix KV; larger batches '
                         'split into chunks)')
    ap.add_argument('--engine', default='fast', choices=['fast', 'exact'],
                    help='fast = shared-prefix engine with a per-image '
                         'prefix LRU; exact = the exact model. A failure '
                         'of the fast engine is a 500, never a silent '
                         'switch to exact.')
    ap.add_argument('--warmup', action='store_true',
                    help='run every route x batch bucket once on synthetic '
                         'scenes before binding the port (the kernels '
                         'build and load then, not on the first request)')
    ap.add_argument('--warmup-buckets', default='1,4,16',
                    help='comma-separated S buckets to warm (--warmup)')
    ap.add_argument('--warmup-prompt-sizes', default='1,5,9',
                    help='comma-separated prompt patch counts to warm '
                         '(--warmup): one per suffix bucket of the '
                         'active+passive union count (4/8/16/...)')
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    kw = dict(engine=args.engine, prefix_cache_size=args.prefix_cache_size,
              seed=args.seed, batch_window_ms=args.batch_window_ms,
              max_batch_samples=args.max_batch_samples,
              max_scene_batch=args.max_scene_batch)
    if args.imu_conditioned:
        G = build_imu_generator(args, device=args.device)
        service = ImuCwmService(G, args.img_size, **kw)
    else:
        G = build_generator(args, device=args.device)
        service = CwmService(G, args.img_size, **kw)
    backend = G.device.type
    if args.warmup:
        buckets = tuple(int(v) for v in args.warmup_buckets.split(',') if v)
        sizes = tuple(int(v) for v in args.warmup_prompt_sizes.split(',')
                      if v)
        print(f'warming up {len(buckets)} buckets x {len(sizes)} prompt '
              f'sizes (backend={backend})...', flush=True)
        warmed = service.warmup(buckets=buckets, active_counts=sizes)
        total = sum(dt for (_, _, dt) in warmed)
        print(f'warmup done: {len(warmed)} dispatches in {total:.1f}s',
              flush=True)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(service, backend))
    mode = 'imu-conditioned ' if args.imu_conditioned else ''
    print(f'serving {mode}{args.model} @ {args.img_size}px on '
          f'http://{args.host}:{args.port} (backend={backend})', flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == '__main__':
    main()
