"""Counterfactual flow sampling — the core Spelke-segmentation workload.

Port of counterfactualworldmodels_tpu/pipelines/segmentation.py: the exact
and the shared-prefix dispatches (one scene, or one scene per sample with
stacked prefix caches), ``compute_flow_corrs`` and ``FlowGenerator``.

``FlowGenerator`` routes each call BEFORE the engine runs, by the explicit
preconditions of the shared-prefix factorization (``_fast_ok`` and
``_fast_predict_ok``): a prompt that misses one takes the exact path for
that call, and the engine stays on. There is no fallback after a failure:
an exception raised inside the engine (a kernel's included) reaches the
caller.
"""
from __future__ import annotations

import copy
import os
from typing import Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ..masking import generators
from ..models import fast_vmae
from ..models.fast_vmae import _predict_videos_core
from ..models.raft.raft import RAFT, apply_raft_shared0, apply_raft_video
from ..ops.sampling import boltzmann
from ..utils import profiling
from . import perturbation as perturb
from .filters import FlowSampleFilter
from .prediction import (PredictorBasedGenerator, load_raft_checkpoint,
                         make_counterfactuals, predict_video)


def _rect_noise(noise, rows: int, n: int, device):
    """The rectangularizer's draws [rows, n]: given, or from a Generator."""
    if isinstance(noise, torch.Generator):
        return torch.rand(rows, n, generator=noise, device=device) * 0.999
    return torch.as_tensor(noise, device=device).reshape(rows, n)


def counterfactual_videos_and_flows(vmae_module, raft_model, x, passive,
                                    active, shifts,
                                    noise: Union[torch.Tensor,
                                                 torch.Generator],
                                    n_vis: int, normalize: bool,
                                    raft_iters: int, fix_passive: bool,
                                    t_dim: int = 2, device='cuda'):
    """The exact counterfactual step: prompts -> the exact VMAE
    (``apply_vmae``; K1 on the card when the module's attn_impl is 'flash')
    -> RAFT over every sample's frame pair.

    vmae_module: a models.vmae.PretrainVisionTransformerModule (it carries
    its weights); raft_model: a models.raft.raft.RAFT module. x
    [B,T,C,H,W]; passive/active bool [B,N,S]; shifts int [B,S,2] (patch
    units); noise: the rectangularizer's uniform [0, 0.999) draws
    [B, S, n] (n the patches per frame; the JAX package's per-sample keys)
    or a torch.Generator to draw them from. Returns (videos
    [B*S,T,C,H,W], flows [B*S,1,2,H,W], masks [B*S,N])."""
    dev = resolve_device(device)
    x, passive, active, shifts = (torch.as_tensor(v, device=dev)
                                  for v in (x, passive, active, shifts))
    b, s = x.shape[0], passive.shape[-1]
    n = vmae_module.cfg.num_patches_per_frame
    noise = _rect_noise(noise, b * s, n, dev).reshape(b, s, n)
    x_mocos, mask_mocos = make_counterfactuals(
        x, passive, active, shifts, noise, vmae_module.cfg.full_patch_size,
        n_vis, fix_passive=fix_passive)
    y = predict_video(vmae_module, x_mocos, mask_mocos, n_vis, normalize,
                      None, t_dim)
    flows = apply_raft_video(raft_model, y, False, raft_iters, True)
    return y, flows, mask_mocos


def compute_flow_corrs(flow_samples: torch.Tensor,
                       flow_samples_swap: Optional[torch.Tensor] = None,
                       downsample: int = 1,
                       take_top_k: Optional[int] = None,
                       do_spearman: bool = False,
                       thresh: Optional[float] = None,
                       use_covariance: bool = False,
                       eps: float = 1e-12,
                       binarize: bool = False,
                       normalize: bool = False,
                       zscore: bool = False,
                       range_thresh: Optional[float] = None) -> torch.Tensor:
    """Pixel x pixel covariance / correlation of flow magnitude across
    counterfactual samples. flow_samples: [B, C, H, W, S]. Returns
    [B, 1, H/ds, W/ds, H/ds, W/ds]. Raises ValueError when take_top_k
    exceeds S."""
    b, c, h, w, s = flow_samples.shape
    if s == 0:
        flow_samples = torch.zeros((b, c, h, w, 1), dtype=torch.float32,
                                   device=flow_samples.device)
        s = 1
    k = s if take_top_k is None else take_top_k
    if k > s:
        raise ValueError(f'take_top_k={k} exceeds the {s} flow samples')
    ds = downsample

    def _ds(fs):
        fs = fs[..., :k]
        return fs.reshape(b, c, h // ds, ds, w // ds, ds, k).mean((3, 5))

    flow_inp = _ds(flow_samples)
    if flow_samples_swap is not None:
        flow_inp = torch.cat([flow_inp, _ds(flow_samples_swap)], -1)
    # an RMS over the channels: sqrt(mean_c(x^2))
    flow_inp = torch.sqrt((flow_inp ** 2).mean(1))
    flow_inp = flow_inp.reshape(b, -1, flow_inp.shape[-1])

    def per_batch(fi):
        if do_spearman:
            # a single argsort (a permutation, not the rank vector true
            # Spearman needs), as the reference and the JAX package do
            fi = torch.argsort(fi, dim=-1, stable=True).float()
        if thresh is not None and not binarize:
            fi = fi * (fi > thresh).to(fi.dtype)
        elif thresh is not None:
            fi = (fi > thresh).float()
        elif range_thresh is not None:
            fi = fi - fi.amin(0, keepdim=True)
            rng = fi.amax(0, keepdim=True)
            fi = (fi > (range_thresh * rng)).float()
        if normalize:
            fi = fi / torch.clamp(fi.amax(0, keepdim=True), min=eps)
        if zscore:
            mn = fi.mean(0)
            std = torch.clamp(fi.std(0, correction=0), min=eps)
            fi = (fi - mn[None]) / std[None]
        cc = torch.cov(fi) if use_covariance else torch.corrcoef(fi)
        return torch.nan_to_num(cc, nan=0.0)

    corrs = torch.stack([per_batch(fi) for fi in flow_inp])
    return corrs.reshape(b, 1, h // ds, w // ds, h // ds, w // ds)


class FlowGenerator(PredictorBasedGenerator):
    """Masked predictor + RAFT flow probe + counterfactual flow sampling.

    flow_model: a models.raft.raft.RAFT module on the generator's device
    (default: a new large RAFT); flow_params / flow_model_load_path: a
    reference-layout RAFT state dict (or checkpoint) to load into it with
    strict=True. engine 'fast' runs supported prompts through the
    shared-prefix engine with a PrefixCache LRU of ``prefix_cache_size``
    scenes; 'exact' always runs the exact model."""

    default_flow_filter_params = {
        'filter_methods': ['patch_magnitude', 'flow_area', 'num_corners'],
        'flow_magnitude_threshold': 5.0,
        'flow_area_threshold': 0.75,
        'num_corners_threshold': 2,
    }
    default_patch_sampling_kwargs = {
        'energy_power': 1,
        'pool_mode': 'mean',
    }

    def __init__(self, *args,
                 flow_model: Optional[RAFT] = None,
                 flow_params=None,
                 flow_model_load_path: Optional[str] = None,
                 flow_model_kwargs={},
                 flow_sample_filter: Optional[FlowSampleFilter] = None,
                 raft_iters: int = 24,
                 patch_sampling_func=(
                     generators.RotatedTableEnergyMaskingGenerator),
                 patch_sampling_kwargs={},
                 engine: str = 'fast',
                 prefix_cache_size: int = 4,
                 prefix_pool=None,
                 suffix_pool=None,
                 fast_gelu: Optional[str] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if engine not in ('exact', 'fast'):
            raise ValueError(f'engine must be "exact" or "fast": {engine!r}')
        self.engine = engine
        self.prefix_cache_size = prefix_cache_size

        # pooled-prefix rungs of the fast engine ('auto': by the grid, see
        # fast_vmae.resolve_pools); env overrides CWM_PREFIX_POOL /
        # CWM_SUFFIX_POOL / CWM_FAST_GELU
        def _pool_knob(value, env):
            if value is None:
                value = os.environ.get(env, 'auto') or 'auto'
            if value != 'auto':
                value = int(value)
                if value < 1:
                    raise ValueError(f'{env} must be >= 1: {value}')
            return value

        self.prefix_pool = _pool_knob(prefix_pool, 'CWM_PREFIX_POOL')
        self.suffix_pool = _pool_knob(suffix_pool, 'CWM_SUFFIX_POOL')
        if fast_gelu is None:
            fast_gelu = os.environ.get('CWM_FAST_GELU', 'auto') or 'auto'
        if fast_gelu not in ('auto', 'erf', 'tanh'):
            raise ValueError(f'fast_gelu: {fast_gelu!r}')
        self.fast_gelu = fast_gelu
        self._prefix_lru = None          # built on the first fast call
        self._fast_params_src = None     # identity key: rebuilt on a swap
        self._fast_params = None
        self.raft_iters = raft_iters
        self.flow_params = None
        self.flow_model = None
        self.set_flow_model(flow_model=flow_model, flow_params=flow_params,
                            flow_model_load_path=flow_model_load_path,
                            **flow_model_kwargs)
        if flow_sample_filter is None:
            flow_sample_filter = FlowSampleFilter(
                **self.default_flow_filter_params)
        self.flow_sample_filter = flow_sample_filter

        self._patch_sampling_func = patch_sampling_func
        self._patch_sampling_kwargs = copy.deepcopy(
            self.default_patch_sampling_kwargs)
        self._patch_sampling_kwargs.update(patch_sampling_kwargs)
        self.patch_sampler = None
        self.set_patch_sampler()

    # ------------------------------------------------------------------
    def set_flow_model(self, flow_model=None, flow_params=None,
                       flow_model_load_path=None, **kwargs):
        """Swap the flow probe: with no model given, build a large RAFT on
        the device. Weights (flow_params, or the checkpoint at
        flow_model_load_path, or else the weights loaded before) load into
        it with strict=True; with none, the model keeps its own."""
        if flow_model is None:
            flow_model = RAFT(iters=self.raft_iters, device=self.device,
                              **kwargs)
        self._check_device(flow_model, 'flow_model')
        if flow_params is None and flow_model_load_path is not None:
            flow_params = load_raft_checkpoint(flow_model_load_path)
        if flow_params is not None:
            self.flow_params = flow_params
        if self.flow_params is not None:
            flow_model.load_state_dict(self.flow_params, strict=True)
        self.flow_model = flow_model.eval()

    def set_raft_iters(self, iters=None):
        self.raft_iters = iters

    def set_flow_sample_filter(self, params=None):
        self.flow_sample_filter = (None if params is None
                                   else FlowSampleFilter(**params))

    def set_patch_sampler(self, num_visible=1, mask_ratio=None, **kwargs):
        if self.patch_sampler is None or kwargs:
            kw = copy.deepcopy(self._patch_sampling_kwargs)
            kw.update(kwargs)
            self.patch_sampler = self._patch_sampling_func(
                input_size=self.mask_shape, mask_ratio=(mask_ratio or 0),
                seed=int(self.rng.randint(9999)), always_batch=True,
                device=self.device, **kw)
        if mask_ratio is not None:
            self.patch_sampler.mask_ratio = mask_ratio
        elif num_visible is not None:
            cf = getattr(self.patch_sampler, 'cf', 1)
            self.patch_sampler.num_visible = num_visible * cf ** 2

    def _draw_patch_indices(self, p: torch.Tensor, num_points: int):
        """The patch sampler's categorical draws: num_points indices with
        replacement from each row of the probabilities p [B, G]."""
        return torch.multinomial(p, num_points, replacement=True,
                                 generator=self.generator)

    def sample_patches_from_energy(self, energy=None, num_samples=10,
                                   num_visible=1, beta=None, **kwargs):
        """[B, N, S] masks with ~num_visible patches sampled per energy
        map."""
        self.set_patch_sampler(num_visible, **kwargs)
        if num_visible == 0:
            return torch.stack([self.get_zeros_mask()
                                for _ in range(num_samples)], -1)
        if energy is None:
            if self.x is None:
                raise ValueError('no energy and no input to sample from')
            energy = torch.ones_like(self.x[:, 0, 0:1])
        energy = boltzmann(self._tensor(energy), beta)
        return torch.stack([self.patch_sampler(
            energy, indices=self._draw_patch_indices)
            for _ in range(num_samples)], -1)

    # ------------------------------------------------------------------
    @staticmethod
    def batch_to_samples(flows, t=0, b=1):
        if flows.dim() != 5:
            raise ValueError(
                f'expected [B*S, T, C, H, W]: {tuple(flows.shape)}')
        s = flows.shape[0] // b
        f = flows[:, t].reshape(b, s, *flows.shape[2:])
        return f.movedim(1, -1)

    def _batch_to_samples(self, flows, t=0):
        if flows.dim() != 5:
            flows = flows[:, None]
            t = 0
        return self.batch_to_samples(flows, t=t, b=self.x.shape[0])

    def predict_flow(self, vid, backward=False, iters=None, **kwargs):
        if iters is not None:
            self.set_raft_iters(iters)
        return apply_raft_video(self.flow_model, self._tensor(vid), backward,
                                self.raft_iters, True)

    def predict_video_and_flow(self, x=None, mask=None, backward=False,
                               propagate_error=False, **kwargs):
        """Sliding frame-pair prediction + flow."""
        if x is None:
            x = self.x
        if mask is None:
            mask = self.mask
        x = self._tensor(x)
        t = x.shape[1]
        dt = self.sequence_length
        preds = [x[:, 0:1]]
        for i in range(t - dt + 1):
            preds.append(self.predict(x[:, i:i + dt], mask, frame=1, **kwargs))
        x_pred = torch.cat(preds, 1)
        if propagate_error:
            return x_pred, self.predict_flow(x_pred, backward)
        fp = []
        for i in range(t - dt + 1):
            pair = torch.cat([x[:, i:i + 1], x_pred[:, i + 1:i + 2],
                              x[:, i + 2:i + dt]], 1)
            fp.append(self.predict_flow(pair, backward))
        return x_pred, torch.cat(fp, 1)

    def predict_video_and_flow_per_sample(self, x, masks, backward=False,
                                          **kwargs):
        if masks.dim() != 3:
            raise ValueError(f'expected masks [B, N, S]: {tuple(masks.shape)}')
        b, _, s = masks.shape
        ys = self.predict_per_sample(x, masks, frame=None,
                                     split_samples=False, **kwargs)
        flows = self.predict_flow(ys, backward)
        ys_s = ys.reshape(b, s, *ys.shape[1:]).movedim(1, -1)
        flows_s = flows.reshape(b, s, *flows.shape[1:]).movedim(1, -1)
        return ys_s, flows_s

    def predict_flow_per_sample(self, x, masks, backward=False, **kwargs):
        """Flows of the per-sample predictions, sample axis last (extra
        kwargs go to predict_flow, e.g. ``iters``)."""
        if masks.dim() != 3:
            raise ValueError(f'expected masks [B, N, S]: {tuple(masks.shape)}')
        s = masks.shape[-1]
        ys = self.predict_per_sample(x, masks, frame=None,
                                     split_samples=False)
        flows = self.predict_flow(ys, backward, **kwargs)
        return flows.reshape(-1, s, *flows.shape[1:]).movedim(1, -1)

    # ------------------------------------------------------------------
    def compute_flow_samples_magnitude(self, flows, normalize=True, dim=-4,
                                       eps=1e-2):
        mags = torch.sqrt((flows ** 2).sum(dim, keepdim=True))
        if normalize:
            mags = mags - mags.amin((-3, -2), keepdim=True)
            mags = mags / torch.clamp(mags.amax((-3, -2), keepdim=True),
                                      min=eps)
        return mags

    def compute_mean_motion_map(self, flows, normalize_per_sample=False,
                                normalize=True, dim=-4, eps=1e-2):
        if flows.dim() == 5:
            mags = self.compute_flow_samples_magnitude(
                flows, normalize=normalize_per_sample, dim=dim, eps=eps)
            motion = mags.mean(-1)
        else:
            motion = flows
            normalize = True
        if normalize:
            motion = motion - motion.amin((-2, -1), keepdim=True)
            motion = motion / torch.clamp(
                motion.amax((-2, -1), keepdim=True), min=eps)
        return motion

    # ------------------------------------------------------------------
    def reset_shifts(self):
        self.shifts = []

    def _prep_shifts(self, shifts, num_samples):
        if shifts is None:
            return self._draw_shifts(num_samples)
        # arrays / tensors are [D=2, S]; lists / tuples are [S][2] (or a
        # single [dy, dx] pair)
        is_array = hasattr(shifts, 'shape')
        if isinstance(shifts, torch.Tensor):
            profiling.count('host_sync.shifts_arg')
            shifts = shifts.cpu().numpy()
        shifts = np.asarray(shifts)
        if is_array and shifts.ndim == 2:
            if shifts.shape[0] != 2:
                raise ValueError(
                    f'array shifts must be [2, S]: {shifts.shape}')
            shifts = shifts.T
        if shifts.ndim == 1:
            shifts = shifts[None]
        if shifts.shape[0] == 1 and num_samples > 1:
            shifts = np.tile(shifts, (num_samples, 1))
        if shifts.shape != (num_samples, 2):
            raise ValueError(f'shifts of shape {shifts.shape} for '
                             f'{num_samples} samples')
        profiling.count('host_sync.shifts_upload')
        return self._tensor(shifts.astype(np.int64))

    def _n_vis_target(self, passive, active):
        """Visible-count target: the max over rows of the unshifted
        combined mask's visible count. passive/active bool [R, N]."""
        n = passive.shape[1]
        npf = n // self.sequence_length
        vis_f0 = (~passive[:, :npf] | ~active[:, :npf]).sum(1)
        vis_f1 = ((~passive[:, npf:] & active[:, npf:])
                  | ~active[:, npf:]).sum(1)
        profiling.count('host_sync.n_vis')
        return int((vis_f0 + vis_f1).max())

    def create_motion_counterfactuals(self, x, masks, active_patches=None,
                                      shifts=None, frame=1, num_samples=None,
                                      fix_passive=True, reset_shifts=False):
        """Batched counterfactual construction. Returns (x [B*S,T,C,H,W],
        mask [B*S,N])."""
        if reset_shifts or getattr(self, 'shifts', None) is None:
            self.reset_shifts()
        x = self._tensor(x)
        masks = self._tensor(masks)
        if masks.dim() == 2:
            if num_samples is None:
                raise ValueError('2-D masks need num_samples')
            masks = masks[..., None].repeat(1, 1, num_samples)
        if active_patches is None:
            active_patches = torch.ones_like(masks)
        else:
            active_patches = self._tensor(active_patches)
            if active_patches.dim() == 2:
                active_patches = active_patches[..., None].repeat(
                    1, 1, masks.shape[-1])
        b, n, s = masks.shape
        shifts = self._prep_shifts(shifts, s)
        self.shifts.extend(list(shifts.cpu().numpy()))
        if fix_passive:
            x = self.make_static_movie(x[:, 0:1], t=2)
        n_vis = self._n_vis_target(masks.transpose(1, 2).reshape(-1, n),
                                   active_patches.transpose(1, 2)
                                   .reshape(-1, n))
        npf = n // self.sequence_length
        noise = self._draw_prompt_noise(b * s, npf).reshape(b, s, npf)
        return make_counterfactuals(
            x, masks, active_patches, shifts[None].expand(b, s, 2), noise,
            self.patch_size, n_vis, frame=frame, fix_passive=False)

    def _clear_fast_state(self):
        """Drop the device state built from the weights: the exact model,
        the stacked engine weights and the prefix-KV LRU."""
        super()._clear_fast_state()
        self._prefix_lru = None
        self._fast_params_src = None
        self._fast_params = None

    def _pool_config(self, h: int, w: int):
        """The pooling/gelu rung for a dispatch at image size (h, w), see
        fast_vmae.resolve_pools. Returns (prefix_pool, suffix_pool, gelu)."""
        ph, pw = self.patch_size[-2:]
        return fast_vmae.resolve_pools(h // ph, w // pw, self.prefix_pool,
                                       self.suffix_pool, self.fast_gelu)

    def _ensure_fast_engine(self):
        """Build the engine state on first use, keyed on the weights'
        identity: replacing G.params restacks them and drops the prefixes
        cached from the old ones."""
        if (self._prefix_lru is None
                or self._fast_params_src is not self.params):
            self._fast_params_src = self.params
            self._fast_params = fast_vmae.stack_vmae_params(
                self.predictor, self.params, device=self.device)
            self._prefix_lru = fast_vmae.PrefixLru(
                self.predictor, self._fast_params,
                self.imagenet_normalize_inputs, size=self.prefix_cache_size)

    def _fast_predict_ok(self, x, mask, kwargs) -> bool:
        """The engine's preconditions for ``predict``: one two-frame scene,
        frame 0 fully visible, the VMAE predictor with time at dim 2, and no
        extra kwargs."""
        return (self.engine == 'fast' and not kwargs
                and hasattr(self.predictor, 'encoder_depth')
                and self.temporal_dim == 2
                and x.shape[0] == 1 and x.shape[1] == 2
                and not bool(
                    mask[:, :self.predictor.num_patches_per_frame].any()))

    def predict(self, x=None, mask=None, frame=-1, **kwargs):
        """Single prediction. With engine='fast' and the interactive shape
        (one two-frame scene, frame 0 fully visible) it runs the
        shared-prefix engine with the PrefixLru, so a repeat click on a
        scene pays only the frame-1 suffix pass; otherwise the exact
        model."""
        x, mask, n_vis = self._prepare(x, mask)
        if not self._fast_predict_ok(x, mask, kwargs):
            return predict_video(self._exact_module(), x, mask, n_vis,
                                 self.imagenet_normalize_inputs, frame,
                                 self.temporal_dim)
        self._ensure_fast_engine()
        cache, _ = self._prefix_lru.get(x[0:1, 0])
        ppool, spool, gelu = self._pool_config(*x.shape[-2:])
        vid = fast_vmae.predict_videos_shared_prefix(
            self.predictor, self._fast_params, n_vis,
            self.imagenet_normalize_inputs, x, mask, cache,
            prefix_pool=ppool, suffix_pool=spool, gelu=gelu)
        if frame is not None:
            f = frame % vid.shape[1]
            vid = vid[:, f:f + 1]
        return vid

    def _fast_ok(self, x, passive, active, fix_passive) -> bool:
        """The engine's preconditions for a counterfactual chunk: one scene,
        fix_passive, time at dim 2, and no frame-0 token masked in both
        prompt sets (the combined mask is passive & active)."""
        n0 = self.predictor.num_patches_per_frame
        if not (self.engine == 'fast' and self.temporal_dim == 2
                and x.shape[0] == 1 and fix_passive):
            return False
        profiling.count('host_sync.fast_ok')
        return not bool((passive[:, :n0] & active[:, :n0]).any())

    def _counterfactual_chunk(self, x, passive, active, shifts, noise,
                              n_vis, iters, fix_passive):
        """One chunk of prompts: the shared-prefix dispatch with this
        scene's cached prefix when the engine supports the prompts, else
        the exact one. noise: [B, S, n] rectangularizer draws."""
        if not self._fast_ok(x, passive, active, fix_passive):
            return counterfactual_videos_and_flows(
                self._exact_module(), self.flow_model, x, passive, active,
                shifts, noise, n_vis, self.imagenet_normalize_inputs, iters,
                fix_passive, self.temporal_dim, device=self.device)
        self._ensure_fast_engine()
        cache, _ = self._prefix_lru.get(x[0:1, 0])
        ppool, spool, gelu = self._pool_config(*x.shape[-2:])
        n0 = self.predictor.num_patches_per_frame
        n_sfx_pad = fast_vmae.sfx_bucket(n_vis - n0,
                                         self.predictor.num_patches - n0)
        return counterfactual_videos_and_flows_fast(
            self.predictor, self._fast_params, self.flow_model, x, passive,
            active, shifts, noise, n_sfx_pad, self.imagenet_normalize_inputs,
            iters, True, prefix_cache=cache, prefix_pool=ppool,
            suffix_pool=spool, gelu=gelu, n_vis=n_vis)

    def predict_counterfactual_videos_and_flows(
            self, x, active_patches, passive_patches=None, shifts=None,
            num_samples=8, sample_batch_size=8, fix_passive=True,
            max_shift_fraction=None, frame=1, raft_iters=None,
            backward=False, **kwargs):
        """The central API. Returns (videos [B*S, 2, C, H, W], flows
        [B*S, 1, 2, H, W])."""
        with profiling.span('cf.dispatch', request=True):
            with profiling.span('cf.prompts'):
                x, active_patches, passive_patches, shifts, fix_passive, \
                    n_vis = self._prepare_prompts(
                        x, active_patches, passive_patches, shifts,
                        num_samples, fix_passive, max_shift_fraction)
            return self._dispatch_chunks(
                x, active_patches, passive_patches, shifts, n_vis,
                sample_batch_size, fix_passive, raft_iters, backward)

    def _prepare_prompts(self, x, active_patches, passive_patches, shifts,
                         num_samples, fix_passive, max_shift_fraction):
        """The dispatch's inputs on the device: (x [B, 2, C, H, W], active
        and passive [B, N, S], shifts [S, 2], fix_passive, the visible-count
        target)."""
        x = self._tensor(x)
        if x.dim() == 3:
            x = x[None, None].expand(1, 2, *x.shape)
            fix_passive = True
        elif x.dim() == 4:
            x = x[:, None].expand(x.shape[0], 2, *x.shape[1:])
            fix_passive = True
        elif x.dim() == 5 and x.shape[1] == 1:
            x = x.expand(x.shape[0], 2, *x.shape[2:])
        x = x[:, 0:2]
        self.set_input(x)
        self.reset_shifts()
        if max_shift_fraction is not None:
            self.max_shift_fraction = max_shift_fraction

        if passive_patches is None:
            passive_patches = self.get_zeros_mask()[..., None]
        passive_patches = self._tensor(passive_patches)
        active_patches = self._tensor(active_patches)
        if passive_patches.dim() == 2:
            passive_patches = passive_patches[..., None]
        if active_patches.dim() == 2:
            active_patches = active_patches[..., None]

        s = max(active_patches.shape[-1], passive_patches.shape[-1])
        if s == 1 and num_samples > 1:
            s = num_samples
        if shifts is not None:
            s = (len(shifts) if not hasattr(shifts, 'shape')
                 else int(np.prod(tuple(shifts.shape))) // 2)
        shifts = self._prep_shifts(shifts, s)
        profiling.count('host_sync.shifts')
        self.shifts.extend(list(shifts.cpu().numpy()))

        if active_patches.shape[-1] == 1 and s > 1:
            active_patches = active_patches.repeat(1, 1, s)
        if passive_patches.shape[-1] == 1 and s > 1:
            passive_patches = passive_patches.repeat(1, 1, s)
        if not active_patches.shape[-1] == passive_patches.shape[-1] == s:
            raise ValueError(
                f'{active_patches.shape[-1]} active and '
                f'{passive_patches.shape[-1]} passive samples for {s} shifts')

        n = active_patches.shape[1]
        n_vis = self._n_vis_target(
            passive_patches.transpose(1, 2).reshape(-1, n),
            active_patches.transpose(1, 2).reshape(-1, n))
        return x, active_patches, passive_patches, shifts, fix_passive, n_vis

    def _dispatch_chunks(self, x, active_patches, passive_patches, shifts,
                         n_vis, sample_batch_size, fix_passive, raft_iters,
                         backward):
        """The prepared prompts through the engine, ``sample_batch_size``
        samples a chunk."""
        b, n, s = x.shape[0], active_patches.shape[1], shifts.shape[0]
        npf = n // self.sequence_length
        iters = raft_iters if raft_iters is not None else self.raft_iters

        # microbatch over samples
        chunk = max(1, (sample_batch_size or s) // b)
        # backward=True replaces the chunks' forward flows (the predict_flow
        # below), so the in-chunk RAFT runs 1 iteration
        chunk_iters = 1 if backward else iters
        ys, flows = [], []
        for i in range(int(np.ceil(s / chunk))):
            s0, s1 = i * chunk, min((i + 1) * chunk, s)
            with profiling.span('cf.prompts'):
                noise = self._draw_prompt_noise(b * (s1 - s0), npf).reshape(
                    b, s1 - s0, npf)
                sh = shifts[None, s0:s1].expand(b, s1 - s0, 2)
            y, fl, _ = self._counterfactual_chunk(
                x, passive_patches[..., s0:s1], active_patches[..., s0:s1],
                sh, noise, n_vis, chunk_iters, fix_passive)
            ys.append(y.reshape(b, s1 - s0, *y.shape[1:]))
            flows.append(fl.reshape(b, s1 - s0, *fl.shape[1:]))
        with profiling.span('cf.assemble'):
            y = torch.cat(ys, 1).reshape(b * s, 2, *x.shape[2:])
            fl = torch.cat(flows, 1)
            fl = fl.reshape(b * s, *fl.shape[2:])
        if backward:
            fl = self.predict_flow(y, backward=True, iters=iters)
        return y, fl

    def sample_counterfactual_motion_map(self, x,
                                         active_sampling_distribution=None,
                                         passive_sampling_distribution=None,
                                         active_patches=None,
                                         passive_patches=None,
                                         num_active_patches=1,
                                         num_passive_patches=0,
                                         num_samples=8, sample_batch_size=8,
                                         patch_sampling_kwargs={},
                                         do_filter=True, **kwargs):
        """Returns (flows [B,2,H,W,S], active [B,N,S], passive [B,N,S])."""
        self.set_input(x)
        if active_patches is None:
            active_patches = self.sample_patches_from_energy(
                energy=active_sampling_distribution, num_samples=num_samples,
                num_visible=num_active_patches, **patch_sampling_kwargs)
        if passive_patches is None:
            passive_patches = self.sample_patches_from_energy(
                energy=passive_sampling_distribution, num_samples=num_samples,
                num_visible=num_passive_patches, **patch_sampling_kwargs)

        _, flows = self.predict_counterfactual_videos_and_flows(
            x, active_patches=active_patches, passive_patches=passive_patches,
            num_samples=num_samples, sample_batch_size=sample_batch_size,
            fix_passive=True, **kwargs)
        flows = self._batch_to_samples(flows)
        if self.flow_sample_filter is not None and do_filter:
            flows, _ = self.flow_sample_filter(flows, active_patches)
        return flows, active_patches, passive_patches

    compute_flow_corrs = staticmethod(compute_flow_corrs)

    def flowshow(self, flow, set_max_speed=True, frame=0, ax=None,
                 title=None, fontsize=12, **kwargs):
        """Show a flow field [B, 2, H, W] (or frame ``frame`` of
        [B, T, 2, H, W]) as RGB on the HSV wheel (matplotlib), at the
        field's largest speed (or the last one shown)."""
        from ..ops.flow_viz import flow_to_rgb
        from ..vis_utils import imshow
        flow = self._tensor(flow)
        if flow.dim() == 5:
            flow = flow[:, frame]
        if set_max_speed:
            max_speed = float(torch.sqrt((flow ** 2).sum(-3)).max())
            self._last_max_speed = max_speed
        else:
            max_speed = getattr(self, '_last_max_speed', 1.0)
        rgb = flow_to_rgb(flow, max_speed=max(max_speed, 1e-6))
        return imshow(rgb, ax=ax, title=title, fontsize=fontsize, **kwargs)

    def get_error_maps(self, x, mask, frame=1, **kwargs):
        """True vs predicted flow and their error."""
        x = self._tensor(x)
        if x.dim() == 4:
            x = x[:, None]
        if x.shape[1] == 1:
            x = x.expand(x.shape[0], 2, *x.shape[2:])
        self.set_input(x)
        flow_true = self.predict_flow(x)
        y = self.predict(x, mask, frame=None, **kwargs)
        flow_pred = self.predict_flow(y)
        err = torch.sqrt(((flow_true - flow_pred) ** 2).sum(2))
        return {'flow_true': flow_true, 'flow_pred': flow_pred,
                'flow_error': err, 'pred': y}


def counterfactual_videos_and_flows_fast(
        vmae_model, fast_params, raft_model, x, passive, active, shifts,
        noise: Union[torch.Tensor, torch.Generator],
        n_sfx_pad: int, normalize: bool, raft_iters: int, fix_passive: bool,
        prefix_cache=None, prefix_pool: int = 1, suffix_pool: int = 1,
        gelu: str = 'erf', n_vis: Optional[int] = None):
    """Shared-prefix fast path for one scene: B = 1, frame 0 fully visible
    and identical across samples (fix_passive). The ViT runs through the
    prefix-isolated engine (models/fast_vmae.py) and RAFT shares the
    frame-0 feature/context encoders across samples.

    x [1, T, C, H, W]; passive/active bool [1, N, S]; shifts int [1, S, 2]
    (patch units). noise replaces the JAX package's per-sample keys: the
    rectangularizer's uniform [0, 0.999) draws, [1, S, N1] (or [S, N1]),
    or a torch.Generator to draw them from. raft_model is a
    models.raft.raft.RAFT module (it carries its weights, so there is no
    separate raft_params). fast_params: fast_vmae.stack_vmae_params(...).
    n_sfx_pad: bucketed suffix width (fast_vmae.sfx_bucket(n_vis - n0,
    n1)); n_vis: the rectangularizer's per-sample visible-count target.

    Returns (videos [S, T, C, H, W], flows [S, 1, 2, H, W],
    masks [S, N] bool)."""
    if n_vis is None:
        raise TypeError(
            'counterfactual_videos_and_flows_fast: n_vis is required — '
            'pass the rectangularizer target as n_vis=<count> and the '
            'bucketed width (fast_vmae.sfx_bucket(n_vis - n0, n1)) '
            'positionally as n_sfx_pad; without it per-sample visible '
            'counts are data-dependent and can exceed the bucket width')
    b = x.shape[0]
    if b != 1:
        raise ValueError(f'fast path is per-scene (B == 1), got B={b}')
    s = passive.shape[-1]
    n0 = vmae_model.num_patches_per_frame
    n1 = vmae_model.num_patches - n0
    with profiling.span('cf.prompts'):
        noise = _rect_noise(noise, s, n1, x.device)
        x_mocos, mask_mocos = perturb.make_motion_counterfactual(
            x[0], passive[0].T, active[0].T, shifts[0], noise,
            vmae_model.full_patch_size, n_vis_target=n_vis,
            fix_passive=fix_passive)

    y = _predict_videos_core(vmae_model, fast_params, n_sfx_pad, normalize,
                             x_mocos, mask_mocos, prefix_cache, prefix_pool,
                             suffix_pool, gelu)
    flows = apply_raft_shared0(raft_model, y, raft_iters, True)
    return y, flows, mask_mocos


def counterfactual_videos_and_flows_fast_multi(
        vmae_model, fast_params, raft_model, x, passive, active, shifts,
        n_sfx_pad: int, normalize: bool, raft_iters: int, fix_passive: bool,
        noise: Union[torch.Tensor, torch.Generator], prefix_cache,
        n_vis: Optional[int] = None, device='cuda'):
    """Multi-SCENE fast dispatch: each sample carries its OWN scene.

    x [S, T, C, H, W] per-sample scene videos; passive/active bool [S, N];
    shifts int [S, 2]; noise [S, n1] rectangularizer draws (or a
    torch.Generator); prefix_cache a REQUIRED stacked per-sample cache
    (fast_vmae.stack_prefix_caches: scene i's cache at row i). The suffix
    decoder reads each row's prefix panels in place (flash_attention_prefix
    with s0 = S); RAFT runs every sample's pair (frame 0 differs per
    sample, nothing to share). The VMAE runs at the exact rung (pools of
    1, erf gelu), as in the JAX package. Returns as
    counterfactual_videos_and_flows_fast."""
    if n_vis is None:
        raise TypeError(
            'counterfactual_videos_and_flows_fast_multi: n_vis is required '
            '(see counterfactual_videos_and_flows_fast)')
    if prefix_cache is None:
        raise ValueError('counterfactual_videos_and_flows_fast_multi needs '
                         'the stacked per-sample prefix cache')
    dev = resolve_device(device)
    x, passive, active, shifts = (torch.as_tensor(v, device=dev)
                                  for v in (x, passive, active, shifts))
    s = x.shape[0]
    n0 = vmae_model.num_patches_per_frame
    noise = _rect_noise(noise, s, vmae_model.num_patches - n0, dev)
    x_mocos, mask_mocos = perturb.make_motion_counterfactual(
        x, passive, active, shifts, noise, vmae_model.full_patch_size,
        n_vis_target=n_vis, fix_passive=fix_passive)
    y = _predict_videos_core(vmae_model, fast_params, n_sfx_pad, normalize,
                             x_mocos, mask_mocos, prefix_cache)
    flows = apply_raft_video(raft_model, y, iters=raft_iters,
                             scale_inputs=True)
    return y, flows, mask_mocos
