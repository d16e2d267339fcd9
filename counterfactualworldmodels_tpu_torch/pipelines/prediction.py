"""Factual & counterfactual prediction pipeline.

Port of counterfactualworldmodels_tpu/pipelines/prediction.py: the
functional core (``scatter_pred_patches``, ``predict_video``,
``predict_counterfactuals``) and the stateful ``PredictorBasedGenerator``
wrapper with its mask utilities and prediction methods.

``predictor`` is the port's ``PretrainVisionTransformer`` configuration and
``params`` a reference-layout state dict (utils/weights.py); the generator
builds the exact model from them on its device, with
``attn_impl='flash'`` (K1 on the card, its plain version on the CPU).
Where the JAX wrapper holds a PRNG key, the port holds a seeded
``torch.Generator`` on its device; each draw is one method of the wrapper
(``_draw_mask_noise``, ``_draw_shifts``, ``_draw_prompt_noise``,
``_draw_stream_mask``), so tests can put the JAX draws in their place.

Modules carry their weights, so a keypoint predictor is a callable
``x [B, T, C, H, W] -> [B, 1, 1, H, W]`` (the JAX package's also takes its
params), e.g. ``models.raft.raft.RaftKeypointPredictor`` around a
``RAFT(output_dim=1)``; ``keypoint_params`` and
``keypoint_predictor_load_path`` load with strict=True into the module it
wraps. ``MaeWrapper``'s predictor is likewise called without params.

Wrapper video layout: [B, T, C, H, W]; predictor layout: [B, C, T, H, W].
Masks: bool [B, N], True = masked.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..masking import mask_ops
from ..models.vmae import (PretrainVisionTransformerModule, apply_vmae,
                           mask_order, take_tokens)
from ..ops import patches as patch_ops
from ..ops.normalization import imagenet_normalize, imagenet_unnormalize
from ..ops.sampling import boltzmann
from . import perturbation as perturb


def strip_prefixes(sd: Dict, prefixes=('module.',)) -> Dict:
    """State-dict keys without the DDP ``module.`` prefix."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def load_vmae_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference VMAE checkpoint (``.pth``) as a state dict: the
    ``'model'`` entry when there is one, without ``module.`` prefixes."""
    weights = torch.load(path, map_location='cpu', weights_only=False)
    weights = strip_prefixes(weights)
    if 'model' in weights and hasattr(weights['model'], 'keys'):
        weights = strip_prefixes(weights['model'])
    return weights


def load_raft_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference RAFT checkpoint as a state dict (the ``'model'`` entry
    when there is one, without ``module.`` prefixes)."""
    weights = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(weights, dict) and 'model' in weights:
        weights = weights['model']
    return strip_prefixes(weights)


def scatter_pred_patches(y: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                         n_vis: int, patch_size) -> torch.Tensor:
    """Rebuild a video with input at visible patches and predictions at
    masked patches. y: [B, N - n_vis, D] predicted patch vectors (masked
    positions, in row-major order); x: [B, T, C, H, W] the raw input."""
    patches = patch_ops.patchify(x, patch_size, temporal_dim=1)
    order = mask_order(mask)
    x_vis = take_tokens(patches, order[:, :n_vis])
    merged = torch.cat([x_vis, y.to(patches.dtype)], dim=1)
    inv = torch.argsort(order, dim=-1)
    full = take_tokens(merged, inv)
    return patch_ops.unpatchify(full, patch_size, x.shape, temporal_dim=1)


def predict_video(module: PretrainVisionTransformerModule, x, mask,
                  n_vis: int, normalize: bool, frame: Optional[int],
                  t_dim: int = 2):
    """Preprocess -> masked forward -> scatter back -> frame select.

    x: [B, T, C, H, W] wrapper layout. Returns [B, T, C, H, W] (or the
    single frame [B, 1, C, H, W] when ``frame`` is not None). ``t_dim`` is
    where the predictor expects the time axis: 2 transposes to
    [B, C, T, H, W], 1 feeds the wrapper layout through."""
    xm = imagenet_normalize(x, temporal_dim=1) if normalize else x
    if t_dim == 2:
        xm = xm.transpose(1, 2)
    y = apply_vmae(module, xm, mask, n_vis)
    vid = scatter_pred_patches(y, x, mask, n_vis,
                               module.cfg.full_patch_size)
    if frame is not None:
        f = frame % vid.shape[1]
        vid = vid[:, f:f + 1]
    return vid


def make_counterfactuals(x, passive, active, shifts, noise, patch_size,
                         n_vis: int, frame: int = 1,
                         fix_passive: bool = True):
    """Per batch row b, the S prompts of ``make_motion_counterfactual``.
    x [B, T, C, H, W]; passive/active bool [B, N, S]; shifts int [B, S, 2];
    noise [B, S, n] rectangularizer draws. Returns (x [B*S, T, C, H, W],
    masks [B*S, N]), sample-major per batch row."""
    outs = [perturb.make_motion_counterfactual(
        x[i], passive[i].T, active[i].T, shifts[i], noise[i], patch_size,
        n_vis_target=n_vis, frame=frame, fix_passive=fix_passive)
        for i in range(x.shape[0])]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def predict_counterfactuals(module: PretrainVisionTransformerModule, x, masks,
                            n_vis: int, normalize: bool, frame: Optional[int],
                            actives, shifts, n_samples: int,
                            fix_passive: bool = True, t_dim: int = 2, *,
                            noise):
    """Batched counterfactual prediction. x: [B, T, C, H, W]; masks
    (passive) bool [B, N, S]; actives bool [B, N, S]; shifts int [B, S, 2]
    patch units; noise [B, S, n] the rectangularizer's uniform [0, 0.999)
    draws (the JAX package's per-sample keys). Returns (predicted videos
    [B*S, T, C, H, W], the prompts' videos and masks)."""
    if masks.shape[-1] != n_samples:
        raise ValueError(f'masks carry {masks.shape[-1]} samples, not '
                         f'{n_samples}')
    x_mocos, mask_mocos = make_counterfactuals(
        x, masks, actives, shifts, noise, module.cfg.full_patch_size, n_vis,
        fix_passive=fix_passive)
    return (predict_video(module, x_mocos, mask_mocos, n_vis, normalize,
                          frame, t_dim), x_mocos, mask_mocos)


class PredictorBasedGenerator:
    """Stateful wrapper mirroring the reference PredictorBasedGenerator.

    keypoint_predictor: a callable x [B, T, C, H, W] -> [B, 1, 1, H, W]
    (see the module docstring); error_func: the elementwise error of the
    error APIs (default squared error). device: where the weights, inputs
    and draws live ('cuda' by default; it raises without a GPU unless 'cpu'
    is asked for)."""

    def __init__(self,
                 predictor=None,
                 params=None,
                 predictor_load_path: Optional[str] = None,
                 keypoint_predictor=None,
                 keypoint_params=None,
                 keypoint_predictor_load_path: Optional[str] = None,
                 imagenet_normalize_inputs: bool = False,
                 temporal_dim: int = 2,
                 seed: int = 0,
                 mask_generator=None,
                 max_shift_fraction: float = 0.15,
                 error_func=None,
                 device='cuda',
                 **kwargs):
        self.device = resolve_device(device)
        self.error_func = (error_func if error_func is not None
                           else (lambda p, t: (p - t) ** 2))
        self.predictor = predictor
        self.params = params
        self.imagenet_normalize_inputs = imagenet_normalize_inputs
        self.temporal_dim = temporal_dim
        self.max_shift_fraction = max_shift_fraction
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.rng = np.random.RandomState(seed=seed)
        self.mask_generator = mask_generator
        self._module = None
        self._module_src = None
        self.x = None
        self.mask = None
        self.timestamps = None
        self.shifts = []
        if params is None and predictor_load_path is not None:
            self.load_predictor(predictor_load_path)
        self.keypoint_predictor = keypoint_predictor
        self.keypoint_params = None
        if keypoint_params is None and keypoint_predictor_load_path is not None:
            keypoint_params = load_raft_checkpoint(keypoint_predictor_load_path)
        if keypoint_params is not None:
            self.set_keypoint_params(keypoint_params)

    # ------------------------------------------------------------------
    # bookkeeping / properties
    # ------------------------------------------------------------------
    def _tensor(self, x, dtype=None):
        """x (array or tensor) on the generator's device."""
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def _exact_module(self) -> PretrainVisionTransformerModule:
        """The exact model for (predictor, params), built on first use and
        rebuilt when either is replaced: attention through flash_attention
        (K1 on the card), weights loaded with strict=True."""
        src = (self.predictor, id(self.params))
        if self._module is None or self._module_src != src:
            cfg = dataclasses.replace(self.predictor, attn_impl='flash')
            module = PretrainVisionTransformerModule(cfg, device=self.device)
            module.load_state_dict(self.params, strict=True)
            self._module, self._module_src = module.eval(), src
        return self._module

    def _clear_fast_state(self):
        """Drop the device state built from the weights (the exact model)."""
        self._module = None
        self._module_src = None

    def _check_device(self, module: torch.nn.Module, what: str) -> None:
        """Raise unless the module's weights are on the generator's device."""
        dev = next(module.parameters()).device
        want = self.device
        if dev.type != want.type or (want.index is not None
                                     and dev.index != want.index):
            raise ValueError(f'{what} is on {dev}, the generator on '
                             f'{self.device}')

    def keypoint_module(self) -> Optional[torch.nn.Module]:
        """The module the keypoint predictor wraps: the predictor itself when
        it is an nn.Module, else its ``module`` attribute (None if neither)."""
        kp = self.keypoint_predictor
        m = kp if isinstance(kp, torch.nn.Module) else getattr(kp, 'module',
                                                               None)
        return m if isinstance(m, torch.nn.Module) else None

    def set_keypoint_params(self, params) -> None:
        """Load reference-layout keypoint weights with strict=True into the
        module the keypoint predictor wraps; raise if it wraps none."""
        module = self.keypoint_module()
        if module is None:
            raise ValueError('keypoint weights need a keypoint_predictor '
                             'that is an nn.Module or has a `module` one')
        self._check_device(module, 'the keypoint predictor')
        module.load_state_dict(params, strict=True)
        self.keypoint_params = params

    def _draw_mask_noise(self, rows: int, n: int) -> torch.Tensor:
        """Uniform [0, 0.999) draws [rows, n] for ``rectangularize`` (one
        key for the block in the JAX package)."""
        return torch.rand(rows, n, generator=self.generator,
                          device=self.device) * 0.999

    def _draw_shifts(self, num_samples):
        """[S, 2] random nonzero patch-unit shifts for the held input's
        image size."""
        return perturb.random_shift(self.max_shift_fraction,
                                    self.x.shape[-2:], self.patch_size,
                                    num=num_samples, generator=self.generator)

    def _draw_prompt_noise(self, rows: int, n: int) -> torch.Tensor:
        """The rectangularizer's uniform [0, 0.999) draws for ``rows``
        prompts of n patches (one key per prompt in the JAX package)."""
        return torch.rand(rows, n, generator=self.generator,
                          device=self.device) * 0.999

    def _draw_stream_mask(self, mask_generator, x):
        """A mask generator's mask for x from this generator's draws (one
        key of the generator's chain in the JAX package): the IMU
        generators' stream masks."""
        return mask_generator(x, generator=self.generator)

    def set_predictor(self, net, predictor_load_path=None, params=None):
        """Swap the predictor and load its weights (a checkpoint path or a
        state dict; neither keeps the old weights). Clears the held
        input/mask state and the device state built from the old weights."""
        self.predictor = net
        if params is not None:
            self.params = params
        self._clear_fast_state()
        self.load_predictor(predictor_load_path)
        self.x = self.mask = None
        self.inp_shape = None

    def load_predictor(self, load_path=None, converter=None):
        """Load predictor weights from a reference checkpoint; ``converter``
        overrides the loader (default ``load_vmae_checkpoint``). With no
        path this is a no-op. The weights load with strict=True here, so a
        checkpoint that does not fit the predictor fails at once."""
        if load_path is None:
            return
        self.params = (converter or load_vmae_checkpoint)(load_path)
        self._predictor_load_path = load_path
        self._exact_module()

    def reset_padding_masks(self):
        """Kept for API parity: padding masks are computed from (mask,
        n_vis) on every call, so there is no cached state to clear."""

    def set_temporal_dim(self, t_dim=1):
        if t_dim not in (1, 2):
            raise ValueError('temporal_dim must be 1 or 2')
        self.temporal_dim = t_dim

    @property
    def t_dim(self):
        return None if self.predictor is None else self.temporal_dim

    @property
    def c_dim(self):
        if self.predictor is None:
            return None
        return 2 if self.temporal_dim == 1 else 1

    def set_image_size(self, *args, **kwargs):
        """The model is built for one image size; another size is an error
        rather than a silent re-configuration."""
        if self.predictor is None:
            raise ValueError("can't set the image size without a predictor")
        size = args[0] if len(args) == 1 else tuple(args)
        if isinstance(size, int):
            size = (size, size)
        built = tuple(self.predictor.img_size)
        if tuple(size) != built:
            raise ValueError(
                f'predictor was built for image size {built}; rebuild the '
                f'model to run at {tuple(size)}')

    @property
    def patch_size(self):
        return self.predictor.full_patch_size

    @property
    def image_size(self):
        return self.predictor.img_size

    @property
    def sequence_length(self):
        return self.predictor.num_frames

    @property
    def mask_shape(self):
        return self.predictor.mask_size

    @property
    def inp_mask_shape(self):
        return (self.x.shape[0], int(np.prod(self.mask_shape)))

    # ------------------------------------------------------------------
    # masks
    # ------------------------------------------------------------------
    def generate_mask(self, x=None):
        if self.mask_generator is None:
            raise ValueError('no mask_generator was given')
        if x is None:
            x = self.x
        mask = self.mask_generator(x, generator=self.generator)
        return self._tensor(mask).reshape(x.shape[0], -1)

    def set_new_mask(self, x=None):
        self.mask = self.generate_mask(x if x is not None else self.x)

    def get_zeros_mask(self, x=None, frame=-1):
        if x is None:
            x = self.x
        t, h, w = self.mask_shape
        mask = torch.zeros((t, h, w), dtype=torch.bool, device=self.device)
        if frame is not None:
            mask[frame] = True
        return mask.reshape(1, -1).expand(x.shape[0], -1)

    def get_fully_visible_mask(self, x=None):
        if x is None:
            x = self.x
        n = int(np.prod(self.mask_shape))
        return torch.zeros((x.shape[0], n), dtype=torch.bool,
                           device=self.device)

    def get_mask_image(self, mask, upsample=False, invert=False, shape=None):
        if shape is None:
            shape = self.mask_shape
        mask = self._tensor(mask).reshape(-1, *shape)
        if upsample:
            mask = mask_ops.upsample_masks(mask.float(), self.x.shape[-2:])
        if invert:
            mask = 1 - mask if upsample else ~mask
        return mask

    def maskshow(self, mask, shape=None, ex=0, **kwargs):
        """Show one example's mask frames as heatmaps (matplotlib)."""
        from ..vis_utils import imshow
        m = self.get_mask_image(mask, shape=shape)
        t = m.shape[1]
        return imshow(m[ex:ex + 1].float().reshape(1, t, 1, *m.shape[-2:]),
                      cmap='inferno', vmin=0, vmax=1, **kwargs)

    @staticmethod
    def invert_mask_frame(mask, size, frame=-1):
        """Invert one temporal frame of a flat [B, N] mask."""
        return mask_ops.invert_mask_frame(torch.as_tensor(mask), size, frame)

    def _invert_mask(self, mask, frame=-1):
        return mask_ops.invert_mask_frame(mask, self.mask_shape[-2:], frame)

    @staticmethod
    def patch_idx_list_from_mask(mask):
        """[b, t, i, j] index lists of the VISIBLE patches of a 4-D mask
        image."""
        mask = torch.as_tensor(mask).cpu().numpy()
        if mask.ndim != 4:
            raise ValueError(f'expected a [B, T, h, w] mask: {mask.shape}')
        return [list(p) for p in np.argwhere(~mask)]

    @staticmethod
    def make_visible_from_patch_idx_list(mask, patch_idx_list, stride=1,
                                         b=0, t=-1):
        """Reveal the patches at the listed positions in a 4-D mask image.
        Index rows may be (i, j), (t, i, j) or (b, t, i, j); pixel
        coordinates become patch coordinates by ``stride``. Returns a new
        mask."""
        mask = torch.as_tensor(mask).clone()
        if len(patch_idx_list) == 0:
            return mask
        idx = np.asarray(patch_idx_list, dtype=np.int64)
        inds_h = (idx[:, -2] // stride) % mask.shape[-2]
        inds_w = (idx[:, -1] // stride) % mask.shape[-1]
        if idx.shape[-1] == 2:
            inds_b = np.full_like(inds_h, b)
            inds_t = np.full_like(inds_h, t)
        elif idx.shape[-1] == 3:
            inds_b = np.full_like(inds_h, b)
            inds_t = idx[:, 0]
        elif idx.shape[-1] == 4:
            inds_b, inds_t = idx[:, 0], idx[:, 1]
        else:
            raise ValueError(f'index rows of length {idx.shape[-1]}')
        inds_t = inds_t % mask.shape[1]
        mask[tuple(torch.as_tensor(i, device=mask.device)
                   for i in (inds_b, inds_t, inds_h, inds_w))] = False
        return mask

    def generate_mask_from_patch_idx_list(self, patch_idx_list, stride=None,
                                          b=0, frame=-1):
        """Visible mask at the given patch positions. ``stride`` converts
        pixel coordinates to patch coordinates; the default is the image
        width / mask width when an input is set, else 1."""
        m = self.get_mask_image(self.get_zeros_mask(frame=frame))
        if stride is None:
            stride = (self.inp_shape[-1] // m.shape[-1]
                      if getattr(self, 'inp_shape', None) else 1)
        m = self.make_visible_from_patch_idx_list(
            m, patch_idx_list, stride=stride, b=b, t=frame)
        return m.reshape(m.shape[0], -1)

    def generate_cutout_mask(self, patch_idx_list, radius=1, stride=None,
                             b=0, frame=-1):
        """Visible cutout of the listed patches plus their radius-
        neighborhood in ``frame``."""
        mask = self.generate_mask_from_patch_idx_list(
            patch_idx_list, stride=stride, b=b, frame=frame)
        m = self.get_mask_image(mask).clone()
        f = frame % m.shape[1]
        cutout = mask_ops.patches_adjacent_to_visible(
            m[:, f:f + 1], radius=radius).bool()
        cutout = cutout | (~m[:, f:f + 1])
        m[:, f] = cutout[:, 0]
        return m.reshape(m.shape[0], -1)

    def mask_complement(self, mask1, mask2, frame=-1):
        m1 = self.get_mask_image(mask1)
        m2 = self.get_mask_image(mask2)
        diff = m1 & (~m2)
        if frame is None:
            return (~diff).reshape(diff.shape[0], -1)
        f = frame % m1.shape[1]
        out = m1.clone()
        out[:, f] = ~diff[:, f]
        return out.reshape(diff.shape[0], -1)

    def get_nearby_patches(self, mask, radius=1, upsample=False, shape=None):
        mask = self.get_mask_image(mask, shape=shape)
        nearby = mask_ops.patches_adjacent_to_visible(mask, radius=radius)
        if upsample:
            nearby = mask_ops.upsample_masks(nearby, self.x.shape[-2:])
        return nearby

    def sample_random_masks(self, num_samples=10, num_visible=1,
                            mask_ratio=None):
        if self.mask_generator is None:
            raise ValueError('no mask_generator was given')
        prev = self.mask_generator.num_visible
        if mask_ratio is None:
            self.mask_generator.num_visible = num_visible
        else:
            self.mask_generator.mask_ratio = mask_ratio
        masks = torch.stack([self.generate_mask(self.x)
                             for _ in range(num_samples)], -1)
        self.mask_generator.num_visible = prev
        return masks

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------
    def set_input(self, x, mask=None, make_mask=False, timestamps=None):
        x = self._tensor(x)
        if x.dim() == 4:
            x = x[:, None]
        if x.dim() != 5:
            raise ValueError(f'expected a [B, T, C, H, W] video: '
                             f'{tuple(x.shape)}')
        self.x = x
        self.inp_shape = x.shape
        self.B, self.T, self.C = x.shape[:3]
        if mask is not None:
            self.mask = self._tensor(mask)
        elif make_mask:
            self.set_new_mask(x)
        if timestamps is not None:
            self.timestamps = timestamps

    def make_static_movie(self, x=None, t=None, frame=0):
        if x is None:
            x = self.x
        if t is None:
            t = self.predictor.num_frames
        return perturb.make_static_movie(self._tensor(x), t=t, frame=frame)

    get_static_input = make_static_movie

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def _equalize(self, mask):
        """Ensure equal visible counts; returns (mask, n_vis)."""
        counts = (~mask).sum(-1)
        lo, hi = int(counts.min()), int(counts.max())
        if lo != hi:
            mask = mask_ops.rectangularize(
                mask, num_visible=hi,
                noise=self._draw_mask_noise(*mask.shape))
        return mask, hi

    def _prepare(self, x, mask):
        """x as [B, T, C, H, W] on the device and the mask [B, N] with equal
        visible counts; returns (x, mask, n_vis)."""
        if x is None:
            x = self.x
        if mask is None:
            mask = (self.mask if self.mask is not None
                    else self.generate_mask(x))
        x = self._tensor(x)
        if x.dim() == 4:
            x = x[:, None]
        mask = self._tensor(mask).reshape(x.shape[0], -1)
        mask, n_vis = self._equalize(mask)
        return x, mask, n_vis

    def predict(self, x=None, mask=None, frame=-1, **kwargs):
        x, mask, n_vis = self._prepare(x, mask)
        return predict_video(self._exact_module(), x, mask, n_vis,
                             self.imagenet_normalize_inputs, frame,
                             self.temporal_dim)

    def predict_per_sample(self, x, masks, frame=-1, split_samples=True,
                           **kwargs):
        """Tile B -> B*S over the sample axis of masks [B, N, S]."""
        if masks.dim() != 3:
            raise ValueError(f'expected masks [B, N, S]: {tuple(masks.shape)}')
        if x is None:
            x = self.x
        x = self._tensor(x)
        b, s = x.shape[0], masks.shape[-1]
        x_t = x.repeat_interleave(s, dim=0)
        m_t = self._tensor(masks).transpose(1, 2).reshape(b * s, -1)
        y = self.predict(x_t, m_t, frame=frame, **kwargs)
        if not split_samples:
            return y
        return y.reshape(b, s, *y.shape[1:]).movedim(1, -1)

    def sample_tile(self, z, num_samples):
        return self._tensor(z).repeat_interleave(num_samples, dim=0)

    def sample_tile_all_tensors(self, num_samples, **kwargs):
        """Tile every tensor-valued kwarg over the sample axis."""
        return {k: (self.sample_tile(v, num_samples)
                    if isinstance(v, (torch.Tensor, np.ndarray)) else v)
                for k, v in kwargs.items()}

    def pred_patches_to_video(self, y, x, mask):
        """Public scatter of predicted patch vectors back into the video:
        input content at visible positions, predictions at masked ones."""
        x = self._tensor(x)
        if x.dim() == 4:
            x = x[:, None]
        mask = self._tensor(mask).reshape(x.shape[0], -1)
        counts = (~mask).sum(-1)
        if int(counts.min()) != int(counts.max()):
            raise ValueError('rows must have equal visible counts '
                             '(rectangularize first)')
        return scatter_pred_patches(self._tensor(y), x, mask,
                                    int(counts[0]), self.patch_size)

    def batch_predict_per_sample(self, x, masks, frame=-1, batch_size=None,
                                 sample_dim=None, **kwargs):
        """Micro-batched per-sample prediction. With sample_dim=0 the sample
        axis is already flattened into the batch; otherwise masks is
        [B, N, S]."""
        s = masks.shape[-1] if sample_dim != 0 else masks.shape[0]
        if batch_size is None:
            batch_size = s
        else:
            batch_size = max(1, batch_size // x.shape[0])
        ys = []
        for i in range(int(np.ceil(s / batch_size))):
            b0, b1 = i * batch_size, min((i + 1) * batch_size, s)
            if sample_dim != 0:
                ys.append(self.predict_per_sample(
                    x, masks[..., b0:b1], frame=frame, split_samples=True,
                    **kwargs))
            else:
                ys.append(self.predict(x[b0:b1], masks[b0:b1], frame=frame,
                                       **kwargs))
        return torch.cat(ys, -1 if sample_dim != 0 else 0)

    def predict_with_mask(self, mask, invert_mask=False, *args, **kwargs):
        """Predict on the held input with the given mask."""
        if self.x is None:
            raise ValueError('no input is set (set_input)')
        mask = self._tensor(mask)
        if invert_mask:
            mask = ~mask
        return self.predict(self.x, mask.reshape(*self.inp_mask_shape),
                            *args, **kwargs)

    def error_with_mask(self, mask, invert_mask=False, frame=-1, *args,
                        **kwargs):
        """Prediction error on the held input under the given mask. The
        default single-frame prediction supports frame=-1 only (another
        frame raises IndexError); ``frame=None`` predicts and compares the
        full video."""
        if frame is None:
            x_pred = self.predict_with_mask(mask, invert_mask, frame=None,
                                            *args, **kwargs)
            return self._get_error(x_pred, self.x, dim=-3)
        x_pred = self.predict_with_mask(mask, invert_mask, *args, **kwargs)
        t = x_pred.shape[1]
        if not -t <= frame < t:
            raise IndexError(
                f'frame {frame} out of range for the {t}-frame prediction; '
                f'frame=None compares the full video')
        return self._get_error(x_pred[:, frame][:, None],
                               self.x[:, frame][:, None], dim=-3)

    def get_initial_mask(self, x):
        """Abstract hook, as in the reference."""
        raise NotImplementedError(
            'Need to specify how to get the initial mask')

    def shift_patches_and_mask(self, x, mask, max_shift_fraction=0.1,
                               frame=-1, padding_mode='reflect'):
        """Translate one frame's pixels and its mask by a random
        patch-quantized shift via pad + center-crop. Draws two integers from
        the numpy ``rng``, as the reference does, and keeps its quirk of
        dividing the mask's x-pad by the height patch size (the same for
        square patches). Returns (x [B, C, H, W], mask [B, 1, h, w])."""
        x = self._tensor(x)
        h, w = x.shape[-2:]
        if x.dim() == 5:
            x = x[:, frame]
        max_shift = [int(max_shift_fraction * s) for s in (h, w)]
        dy = int(self.rng.randint(-max_shift[0], max_shift[0] + 1))
        dx = int(self.rng.randint(-max_shift[1], max_shift[1] + 1))
        ph, pw = self.patch_size[-2], self.patch_size[-1]
        dy = (dy // ph) * ph
        dx = (dx // pw) * pw

        def _pad(p):
            return (2 * p, 0) if p > 0 else (0, -2 * p)

        def _shift2d(z, pad_lr, pad_tb):
            zp = torch.nn.functional.pad(z, (*pad_lr, *pad_tb),
                                         mode=padding_mode)
            top = (zp.shape[-2] - z.shape[-2]) // 2
            left = (zp.shape[-1] - z.shape[-1]) // 2
            return zp[..., top:top + z.shape[-2], left:left + z.shape[-1]]

        x_shift = _shift2d(x, _pad(dx), _pad(dy))
        m = self._tensor(mask).reshape(x.shape[0], -1, h // ph, w // pw)
        if m.shape[1] > 1:
            m = m[:, frame][:, None]
        m_shift = _shift2d(m.float(), _pad(dx // ph),
                           _pad(dy // pw)).bool()
        return x_shift, m_shift

    def get_frame_pairs(self, x, frame=None):
        """Pairs (frame_t, target_frame) [B, 2, C, H, W] for every
        non-target frame (target: ``frame``, default the middle one)."""
        x = self._tensor(x)
        if x.dim() != 5:
            raise ValueError(f'expected a [B, T, C, H, W] video: '
                             f'{tuple(x.shape)}')
        t = x.shape[1]
        self.num_frame_pairs = t - 1
        self.target_frame = frame if frame is not None else (t // 2)
        return [torch.stack([x[:, i], x[:, self.target_frame]], 1)
                for i in range(t) if i != self.target_frame]

    # ------------------------------------------------------------------
    # counterfactuals
    # ------------------------------------------------------------------
    def _shift(self, x, mask, active_patches=None, shift=None, frame=1):
        """Shift the active patches of each row by one shift (drawn for the
        held input's size when not given); returns (x_shift, mask_shift)."""
        x = self._tensor(x)
        mask = self._tensor(mask)
        if active_patches is None:
            active_patches = torch.ones_like(mask)
        active_patches = self._tensor(active_patches)
        if shift is None:
            shift = self._draw_shifts(1)[0]
        shift = self._tensor(shift).long()
        self.shift = shift.cpu().numpy().tolist()
        self.shifts.append(shift.cpu().numpy())
        n_vis = int(((~mask) | (~active_patches)).sum(-1).max())
        b = x.shape[0]
        npf = mask.shape[-1] // x.shape[1]
        return perturb.make_motion_counterfactual(
            x, mask, active_patches, shift.expand(b, 2),
            self._draw_prompt_noise(b, npf), self.patch_size,
            n_vis_target=n_vis, frame=frame, fix_passive=False)

    def get_counterfactual_prediction(self, x, mask=None, active_patches=None,
                                      shift=None, fix_passive=False,
                                      **kwargs):
        """Predict the video after shifting the active patches; an image
        becomes a two-frame static movie."""
        x = self._tensor(x)
        if x.dim() == 3:
            x = x[None, None]
        elif x.dim() == 4:
            x = x[:, None]
        if x.shape[1] == 1:
            x = self.make_static_movie(x, t=2)
        self.set_input(x)
        if mask is None:
            mask = self.get_zeros_mask(x)
        if active_patches is None:
            active_patches = self.get_zeros_mask(x)
        if fix_passive:
            x = perturb.make_static(x, self._tensor(mask), self.patch_size)
        x_p, mask_p = self._shift(x, mask, active_patches, shift, frame=1)
        return self.predict(x_p, mask_p, frame=None, **kwargs)

    # ------------------------------------------------------------------
    # errors
    # ------------------------------------------------------------------
    def _get_error(self, pred, gt, dim=-3):
        """Elementwise error summed over ``dim``; the prediction's trailing
        frames are aligned with gt's."""
        t = gt.shape[1]
        return self.error_func(pred[:, -t:], gt).sum(dim, keepdim=True)

    def predict_error(self, x=None, mask=None, target=None, frame=None,
                      dim=-3):
        if x is None:
            x = self.x
        if mask is None:
            mask = self.generate_mask(x)
        pred = self.predict(x, mask, frame=frame)
        target = self._tensor(x if target is None else target)
        if frame is not None:
            target = target[:, frame][:, None]
        return self.error_func(pred, target).sum(dim, keepdim=True)

    def get_error_on_target_region(self, x, mask, target_mask, target=None,
                                   average_error=True, frame=-1,
                                   aggregate_over_patches=True,
                                   patch_size=None, **kwargs):
        """The error inside the target region (the visible entries of
        target_mask), per patch or averaged over the region."""
        x = self._tensor(x)
        target = x if target is None else self._tensor(target)
        target_mask = self._tensor(target_mask)
        th, tw = self.mask_shape[-2:]
        if target_mask.dim() == 2:
            target_mask = target_mask.reshape(x.shape[0], -1, th, tw)
        region = 1.0 - target_mask.float()
        pred = self.predict(x, mask, frame=frame, **kwargs)
        err = self._get_error(pred, target)
        if not aggregate_over_patches:
            return err
        ps = patch_size or self.patch_size
        b, t, _, h, w = err.shape
        err = err.reshape(b, t // ps[0], ps[0], 1, h // ps[1], ps[1],
                          w // ps[2], ps[2]).mean((2, 5, 7))[:, :, 0]
        err = err * region
        if not average_error:
            return err
        return err.sum((1, 2, 3)) / torch.clamp(region.sum((1, 2, 3)), min=1)

    # ------------------------------------------------------------------
    # keypoints
    # ------------------------------------------------------------------
    def predict_keypoints_map(self, x, **kwargs):
        """The keypoint predictor's map [B, 1, 1, H, W] (ones without
        one)."""
        x = self._tensor(x)
        if x.dim() != 5:
            raise ValueError(f'expected a [B, T, C, H, W] video: '
                             f'{tuple(x.shape)}')
        if self.keypoint_predictor is None:
            return torch.ones_like(x[:, 0:1, 0:1])
        return self.keypoint_predictor(x, **kwargs)

    def predict_keypoints_distribution(self, x, power=8, eps=1e-3):
        """sigmoid(map) ** power, min-max normalised per image:
        [B, 1, H, W] in [0, 1]."""
        v = self.predict_keypoints_map(x).squeeze(-3)
        v = torch.sigmoid(v) ** power
        v = v - v.amin((-2, -1), keepdim=True)
        return v / torch.clamp(v.amax((-2, -1), keepdim=True), min=eps)

    def patchify_energy_density(self, density, mode='min', beta=None):
        """Pool an energy density [B, T, C, H, W] (or [B, C, H, W]) over
        each patch by ``mode`` ('mean', 'max' or 'min')."""
        density = boltzmann(self._tensor(density), beta)
        ps = self.patch_size
        red = {'mean': torch.mean, 'max': torch.amax, 'min': torch.amin}[mode]
        if density.dim() == 5:
            b, t, c, h, w = density.shape
            d = density.reshape(b, t // ps[0], ps[0], c, h // ps[1], ps[1],
                                w // ps[2], ps[2])
            return red(d, dim=(2, 5, 7)).squeeze(2)
        b, c, h, w = density.shape
        d = density.reshape(b, c, h // ps[1], ps[1], w // ps[2], ps[2])
        return red(d, dim=(3, 5))

    def __call__(self, x, mask=None, frame=None, **kwargs):
        self.set_input(x, mask)
        if mask is None:
            self.mask = self.generate_mask(self.x)
        return self.predict(self.x, self.mask, frame=frame, **kwargs)

    def forward(self, *args, **kwargs):
        """torch-style alias of __call__ (subclass overrides honored)."""
        return self(*args, **kwargs)

    # ------------------------------------------------------------------
    # visualization support
    # ------------------------------------------------------------------
    def get_masked_pred_patches(self, preds, mask, invert=False,
                                fill_value=None):
        """preds [B, T, C, H, W] kept at the masked patches (True entries of
        mask) and zeroed, or set to ``fill_value`` per channel, at the
        visible ones (the reverse with ``invert``)."""
        preds = self._tensor(preds)
        th, tw = self.mask_shape[-2:]
        mask = self._tensor(mask)
        m = mask.reshape(mask.shape[0], -1, th, tw)
        m_pix = mask_ops.upsample_masks(m, preds.shape[-2:]).to(preds.dtype)
        if invert:
            m_pix = 1.0 - m_pix
        out = preds * m_pix[:, :, None]
        if fill_value is not None:
            fv = torch.as_tensor(fill_value, dtype=preds.dtype,
                                 device=preds.device).reshape(1, 1, -1, 1, 1)
            out = out + (1.0 - m_pix[:, :, None]) * fv
        return out

    @staticmethod
    def unmask_one_patch(mask, idx, mask_shape=None, frame=0):
        """Reveal the patch at idx: a flat index, or with ``mask_shape``
        (t, i, j) or (i, j) in ``frame``. Returns a new mask."""
        mask = torch.as_tensor(mask).clone()
        if mask_shape is None:
            mask[:, idx] = False
            return mask
        m = mask.reshape(-1, *mask_shape)
        if len(idx) == 2:
            idx = [frame] + list(idx)
        m[(slice(None),) + tuple(idx)] = False
        return m.reshape(mask.shape)


class MaeWrapper(PredictorBasedGenerator):
    """Wrapper for single-image MAE models.

    ``predictor`` is any callable with the timm-MAE signature
    ``predictor(x, mask_ratio=..., mask=...) -> (loss, pred_patches, mask)``
    (it carries its weights), with ``unpatchify(pred) -> image``; the
    wrapper handles frame select and imagenet (un)normalization."""

    def __init__(self, *args, unpatchify=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._unpatchify = unpatchify

    def imagenet_normalize(self, x):
        """Single-image [B, 3, H, W] normalize."""
        x = self._tensor(x)
        if x.dim() != 4 or x.shape[1] != 3:
            raise ValueError(f'expected [B, 3, H, W]: {tuple(x.shape)}')
        return imagenet_normalize(x[:, None], temporal_dim=1)[:, 0]

    def imagenet_unnormalize(self, x):
        """Single-image [B, 3, H, W] unnormalize."""
        x = self._tensor(x)
        if x.dim() != 4 or x.shape[1] != 3:
            raise ValueError(f'expected [B, 3, H, W]: {tuple(x.shape)}')
        return imagenet_unnormalize(x[:, None], temporal_dim=1)[:, 0]

    def predict(self, x=None, mask=None, frame=0, mask_ratio=0.9, **kwargs):
        if x is None:
            x = self.x
        x = self._tensor(x)
        is_video = x.dim() == 5
        if is_video:
            x = x[:, frame]
        if self.imagenet_normalize_inputs:
            x = self.imagenet_normalize(x)
        _, y, mask_out = self.predictor(x, mask_ratio=mask_ratio, mask=mask)
        self.mask = mask_out
        if self._unpatchify is not None:
            y = self._unpatchify(y)
        if self.imagenet_normalize_inputs:
            y = self.imagenet_unnormalize(y)
        if is_video:
            y = y[:, None]
        return y
