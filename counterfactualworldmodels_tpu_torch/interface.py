"""Interactive counterfactual-prediction interface (matplotlib event loop).

Port of counterfactualworldmodels_tpu/interface.py. The UI is a thin
stateful shell over a generator (``FlowGenerator`` or
``ImuConditionedFlowGenerator``, on either engine): every compute call goes
through the generator's entry points on its device, the card by default.
It draws only through the axes it is given (``imshow``, ``text``,
``set_title``, ``figure.canvas.mpl_connect``); matplotlib itself is
imported only by ``visualize_correlogram``, which makes its own figure, so
any object with those methods drives the interface without matplotlib.
Its own draws (the random shifts and probe points) come from
``np.random.RandomState(seed)``, as in the JAX package.

Event map:
    click                 toggle an *active* patch (white)
    META-click / right    toggle a *passive* patch (gray)
    SHIFT-click           reset all selections + sample lists
    ALT-click             restore the previous selections
    'd'+drag              set the motion shift by dragging (patch units)
    CTRL / 'f'-click      run ONE counterfactual with the current shift
    'b'-click             run a BATCH of counterfactuals, show mean pred /
                          summed flow / segment
    'x'-click             covariance probe: show the covmat row at the click
    'e'-click             true-vs-predicted flow error maps
    't'-click             run the patch-selector algorithm (if provided)
"""
from __future__ import annotations

import colorsys
import copy
from functools import partial

import numpy as np
import torch

from .ops.flow_viz import FlowToRgb
from .ops.resize import resize_bilinear
from .pipelines.segmentation import compute_flow_corrs
from .vis_utils import imshow, to_numpy_image

compute_flow_cov = partial(compute_flow_corrs, use_covariance=True)


class CounterfactualPredictionInterface:
    """Click-driven Spelke-segmentation UI over a FlowGenerator-style
    backend; it runs on the generator's device."""

    def __init__(self, axes, G, x=None, model_kwargs=None,
                 initial_flow_samples=None, patch_selector=None,
                 size=(224, 224), bbox_corners=None, frame=0,
                 click_patch_width=1, static=True, static_head_motion=True,
                 max_speed=None, max_shift=3, preset_shifts=None,
                 sample_batch_size=8, max_samples_per_batch=32,
                 covmat_downsample=2, normalize_flow_magnitude=False,
                 show_ticks=True, show_error_diff=False,
                 active_color=(1, 1, 1), passive_color=(0.25, 0.25, 0.25),
                 seed=0, **unused):
        if not hasattr(G, 'get_counterfactual_prediction'):
            raise TypeError(f'{type(G).__name__} is not a generator')
        self.G = G
        self.device = G.device
        self.frame = frame
        self.size = tuple(size) if size is not None else None
        self._static = static
        self.static_head_motion = static_head_motion
        self._model_kwargs = dict(model_kwargs or {})
        self.click_patch_width = click_patch_width
        self.sample_batch_size = sample_batch_size
        self.max_samples_per_batch = max_samples_per_batch
        self.max_shift = max_shift
        self._covmat_downsample = covmat_downsample
        self._normalize_flow_magnitude = normalize_flow_magnitude
        self._show_ticks = show_ticks
        self._show_error_diff = show_error_diff
        self._active_color = list(active_color)
        self._passive_color = list(passive_color)
        self.patch_selector = patch_selector

        self.seed = seed
        self.rng = np.random.RandomState(seed)

        if bbox_corners is not None:
            (h1, w1), (h2, w2) = bbox_corners
            x = x[..., h1:h2, w1:w2]
        self.x = x

        # axes: main, corr, flow, seg (any subset)
        self.flow_ax = self.seg_ax = self.corr_ax = None
        flat = (np.asarray(axes, dtype=object).ravel().tolist()
                if hasattr(axes, '__len__') else [axes])
        self.ax = flat[0]
        if len(flat) > 1:
            self.corr_ax = flat[1]
        if len(flat) > 2:
            self.flow_ax = flat[2]
        if len(flat) > 3:
            self.seg_ax = flat[3]

        h = self.size[0] if self.size else 224
        self.text = self.ax.text(0, 1.1 * h, '', va='bottom', ha='left')
        self.connect()

        self.max_speed = max_speed
        self.flow2rgb = FlowToRgb(max_speed=(max_speed or 10),
                                  from_image_coordinates=False,
                                  from_sampling_grid=True)

        self.shift = None
        self.press_loc = None
        self.do_drag = False
        self._show_flow = False
        self.txt = ''

        self.G.set_input(self.get_input())
        self._reset_masks()
        self._store_current_patches()   # ALT-restore baseline
        self.counterfactual_inputs = []
        self.preds_list = []
        self.flow_samples_list = []
        self._corrmat_inds_list = []
        self.shifts = []
        self._flow_corrs = None
        self._num_flow_samples = None
        self._flow_errors = []
        if initial_flow_samples is not None:
            fs = self.G._tensor(initial_flow_samples)
            self.flow_samples_list = [fs[..., i] for i in range(fs.shape[-1])]
        self.set_preset_shifts(preset_shifts)
        self.imshow(self.ax)

    # ------------------------------------------------------------------
    def set_preset_shifts(self, shifts=None):
        if shifts is None:
            self.preset_shifts = None
            return
        if len(shifts[0]) != 2:
            raise ValueError(f'shifts are [dy, dx] pairs: {shifts[0]}')
        self.preset_shifts = list(shifts)
        self.sample_batch_size = len(self.preset_shifts)

    def set_sample_batch_size(self, v):
        self.sample_batch_size = v

    def connect(self):
        canvas = self.ax.figure.canvas
        self.cidpush = canvas.mpl_connect('button_press_event', self.__call__)
        self.cidmove = canvas.mpl_connect('motion_notify_event',
                                          self.drag_to_set_shift)
        self.cidrelease = canvas.mpl_connect('button_release_event',
                                             self.on_release)

    def disconnect(self):
        self.ax.figure.canvas.mpl_disconnect(self.cidpush)

    # ------------------------------------------------------------------
    @property
    def x(self):
        if self._x is None:
            return None
        if self._x.dim() == 5:
            return self._x[:, (self.frame or 0)]
        if self._x.dim() == 4:
            return self._x
        return self._x[None]

    @x.setter
    def x(self, x):
        if x is None:
            self._x = None
            return
        x = self.G._tensor(x)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        self._x_ori = x
        self._x = self.resize(x)

    def resize(self, x):
        if self.size is None or tuple(x.shape[-2:]) == self.size:
            return x
        return resize_bilinear(x, self.size)

    def get_input(self):
        x = self._x
        if x.dim() == 4:
            x = x[:, None]
        if self._static:
            return self.G.make_static_movie(x[:, 0:1],
                                            t=self.G.sequence_length)
        return x

    # ------------------------------------------------------------------
    def imshow(self, ax=None, img=None, txt=None, **kwargs):
        if ax is None:
            return
        if img is None:
            img = self._make_mask_img()
        img = to_numpy_image(img)
        self._img = img
        ax.imshow(np.clip(img, 0, None) if img.ndim == 3 else img, **kwargs)
        if not self._show_ticks:
            ax.set_xticks([])
            ax.set_yticks([])
        if txt is not None:
            self.text.set_text(str(txt))

    def _get_shift_color(self):
        """Color the active patches by the shift direction (hue) and speed
        (value, at most 1)."""
        if self.shift is None:
            return self._active_color
        y, x = np.asarray(self.shift, np.float32) / self.max_shift
        angle = np.arctan2(-y, x)
        speed = min(float(np.sqrt(x ** 2 + y ** 2)), 1.0)
        rgb = np.array(colorsys.hsv_to_rgb(
            float(angle % (2 * np.pi)) / (2 * np.pi), 1.0, speed))
        if rgb.sum() == 0:
            rgb = np.array([0.1, 0.1, 0.1])
        return list(rgb)

    def _make_mask_img(self):
        static = self.G.make_static_movie(self.G.x[:, 0:1],
                                          t=self.G.sequence_length)
        img = self.G.get_masked_pred_patches(
            static, self.active_patches, fill_value=self._get_shift_color())
        img = self.G.get_masked_pred_patches(
            img, self.passive_patches, fill_value=self._passive_color)
        self.masked_img = img
        return img[:, -1]

    # ------------------------------------------------------------------
    def _reset_masks(self):
        # the *_last fields stay: the SHIFT handler stores the current
        # selection just before resetting so ALT-click can restore it
        self.G.set_input(self.get_input())
        self.mask = self.G.get_zeros_mask(self.get_input())
        self.active_patches = self.G.get_zeros_mask(self.get_input())
        self.passive_patches = self.G.get_zeros_mask(self.get_input())

    def _store_current_patches(self):
        self._active_patches_last = self.active_patches
        self._passive_patches_last = self.passive_patches

    def _restore_last_patches(self):
        self.active_patches = self._active_patches_last
        self.passive_patches = self._passive_patches_last

    def _get_patch_inds(self, event):
        if event.xdata is None or event.ydata is None:
            return None, None
        return int(np.floor(event.ydata)), int(np.floor(event.xdata))

    def _add_patch(self, i, j, mask, t=-1):
        """Toggle click_patch_width^2 patches at pixel (i, j)."""
        t_grid, h_grid, w_grid = self.G.mask_shape
        pi = i // self.G.patch_size[-2]
        pj = j // self.G.patch_size[-1]
        n = h_grid * w_grid
        m = mask.clone()
        for oi in range(self.click_patch_width):
            for oj in range(self.click_patch_width):
                ii = (pi + oi) % h_grid
                jj = (pj + oj) % w_grid
                ind = (t % t_grid) * n + ii * w_grid + jj
                m[0, ind] = ~m[0, ind]
        return m

    def sample_shift(self):
        shift, m = [0, 0], self.max_shift
        while sum(s ** 2 for s in shift) == 0:
            shift = [int(self.rng.randint(-m, m + 1)),
                     int(self.rng.randint(-m, m + 1))]
        return shift

    def drag_to_set_shift(self, event):
        if self.press_loc is None or not self.do_drag:
            return
        if event.xdata is None or event.ydata is None:
            return
        dx = event.xdata - self.press_loc[0]
        dy = event.ydata - self.press_loc[1]
        shift = np.array([dy, dx]) // np.array(
            [self.G.patch_size[-2], self.G.patch_size[-1]])
        shift = np.clip(shift, -self.max_shift, self.max_shift)
        self.shift = [int(s) for s in shift]
        self.text.set_text('shift by %s' % str(self.shift))

    def on_release(self, event):
        self.press_loc = None
        self.do_drag = False
        if not self._show_flow:
            self.imshow(self.ax, self._make_mask_img(), self.txt)

    # ------------------------------------------------------------------
    def _get_flow(self, shift, static=True, **kwargs):
        """One counterfactual prediction (+ flow) with the current patch
        selections."""
        x = self.G.x
        if static:
            x = self.G.make_static_movie(x[:, 0:1], t=2)
        extra = dict(kwargs)
        if hasattr(self.G, '_get_head_motion'):
            # the interface's head-motion conditioning, for IMU-conditioned
            # generators
            extra.setdefault('static_head_motion', self.static_head_motion)
            extra.setdefault('mask_head_motion', False)
        y = self.G.get_counterfactual_prediction(
            x, active_patches=self.active_patches,
            mask=self.passive_patches, shift=shift, **extra,
            **self._model_kwargs)
        flow = None
        if hasattr(self.G, 'predict_flow'):
            flow = self.G.predict_flow(y)
        return y, flow

    def _reset_flow_samples_list(self):
        self._flow_samples_list_last = list(self.flow_samples_list)
        self._preds_list_last = list(self.preds_list)
        self.counterfactual_inputs = []
        self.flow_samples_list, self.preds_list = [], []
        self.shifts = []
        self._flow_corrs = None
        # error maps restart with the selection
        self._flow_errors = []

    def _get_flow_mag(self, flow, normalize=True, dim=-3, eps=1e-2):
        mag = torch.sqrt((flow ** 2).sum(dim))
        if normalize:
            mag = mag - mag.amin((-2, -1), keepdim=True)
            mag = mag / torch.clamp(mag.amax((-2, -1), keepdim=True), min=eps)
        return mag

    def show_last_segment(self, flow, ax=None, dim=-3):
        seg = self._get_flow_mag(flow, True)[:, 0]
        img = self.get_input()[:, 0] * seg[:, None]
        self.imshow(ax=(ax or self.seg_ax), img=img)

    def show_corrmat_segment(self, i=0, j=0, sample_inds=None, downsample=1):
        """Covariance-row probe at patch (i, j)."""
        if not self.flow_samples_list or self.corr_ax is None:
            return
        inds = sample_inds or range(len(self.flow_samples_list))
        samples = [self.flow_samples_list[k].squeeze(1)
                   if self.flow_samples_list[k].dim() == 5
                   else self.flow_samples_list[k] for k in inds]
        if len(samples) == 1:
            self.show_last_segment(samples[0], ax=self.corr_ax)
            return
        samples = torch.stack(samples, -1)
        if samples.dim() == 6:
            samples = samples[:, 0]
        if (self._flow_corrs is None or
                self._num_flow_samples != samples.shape[-1]):
            self._flow_corrs = torch.relu(compute_flow_cov(
                samples, downsample=downsample))
            self._num_flow_samples = samples.shape[-1]
        s = downsample or 1
        self.imshow(ax=self.corr_ax,
                    img=self._flow_corrs[:, :, i // s, j // s])
        self.corr_ax.set_title(
            'Covmat at [%d,%d] from %d flow samples'
            % (i, j, samples.shape[-1]), fontsize=10)

    def show_flow_error(self, flow_error):
        flow_error = self.G._tensor(flow_error)
        if self._show_error_diff and self._flow_errors:
            prev = self._flow_errors[-1]
            self._flow_errors.append(flow_error)
            flow_error = prev - flow_error
            vmin, vmax = float(flow_error.min()), float(flow_error.max())
        else:
            self._flow_errors.append(flow_error)
            vmin, vmax = 0, float(flow_error.max())
        self.imshow(img=flow_error[:, 0], ax=self.corr_ax, cmap='RdBu_r',
                    vmin=vmin, vmax=vmax)
        if self.corr_ax is not None:
            self.corr_ax.set_title(
                '%s flow error | max=%0.1f'
                % ('diff' if self._show_error_diff else 'abs', vmax),
                fontsize=12)

    # ------------------------------------------------------------------
    def __call__(self, event):
        """Event dispatch."""
        key = str(event.key).upper()
        if self._show_flow and key != 'CONTROL':
            self._show_flow = False
            self.G.set_input(self.get_input())
            if key == 'SHIFT':
                self._store_current_patches()
                self._reset_masks()

        i, j = self._get_patch_inds(event)
        if i is None or j is None:
            return
        self.txt = 'xdata=%d, ydata=%d, key=%s' % (j, i, event.key)

        self.do_drag = key == 'D'
        self.press_loc = (event.xdata, event.ydata)
        if bool(getattr(event, 'dblclick', False)) and self.do_drag:
            self.shift = self.press_loc = None
            self.do_drag = False
            self.imshow(self.ax, self._make_mask_img(), 'reset_shift')
            return

        button = str(event.button).upper()
        t_click = (self.frame or 0) + 1

        if event.key is None and 'RIGHT' not in button and not self.do_drag:
            self.active_patches = self._add_patch(i, j, self.active_patches,
                                                  t=t_click)
        elif key == 'META' or 'RIGHT' in button:
            self.passive_patches = self._add_patch(i, j, self.passive_patches,
                                                   t=t_click)
        elif key == 'SHIFT':
            self._store_current_patches()
            self._reset_masks()
            self._reset_flow_samples_list()
            self._corrmat_inds_list = []
        elif key == 'ALT':
            self._restore_last_patches()
            self.flow_samples_list = list(
                getattr(self, '_flow_samples_list_last', []))
        elif key in ('CONTROL', 'F'):
            self._run_single_counterfactual()
        elif key == 'B':
            self._run_batch_counterfactuals()
        elif key == 'X':
            self._corrmat_inds_list.append([i, j])
            self.show_corrmat_segment(i, j, sample_inds=None,
                                      downsample=self._covmat_downsample)
        elif key == 'E':
            self._run_error_maps()
        elif key == 'T':
            self._run_patch_selector()

        if not self._show_flow:
            self.imshow(self.ax, self._make_mask_img(), self.txt)

    # -- handlers -------------------------------------------------------
    def _run_single_counterfactual(self):
        self._show_flow = True
        shift = self.shift if self.shift is not None else self.sample_shift()
        self.shifts.append(shift)
        self._make_mask_img()
        y, flow = self._get_flow(shift, static=True)
        self.y, self.flow = y, flow
        if flow is not None:
            if self._normalize_flow_magnitude:
                self.flow2rgb.max_speed = float(
                    torch.sqrt((flow ** 2).sum(-3)).max())
            flow_rgb = self.flow2rgb(flow[:, 0])
            self.flow_samples_list.append(flow)
            self.imshow(self.flow_ax or self.ax, flow_rgb,
                        txt='shift=%s, max flow=%0.1f'
                        % (shift, self.flow2rgb.max_speed))
        self.preds_list.append(y)
        self.counterfactual_inputs.append(self.masked_img)
        if self.corr_ax is not None:
            self.imshow(self.corr_ax, y[:, -1])
        if flow is not None:
            self.show_last_segment(flow)
        self._store_current_patches()

    def _run_batch_counterfactuals(self):
        b = self._x.shape[0] if self._x.dim() >= 4 else 1
        ys, fs = self.G.predict_counterfactual_videos_and_flows(
            self._x, active_patches=self.active_patches,
            passive_patches=self.passive_patches,
            shifts=self.preset_shifts, num_samples=self.sample_batch_size,
            sample_batch_size=self.max_samples_per_batch,
            mask_head_motion=False,
            static_head_motion=self.static_head_motion,
            **self._model_kwargs)
        s = ys.shape[0] // b
        ys_s = ys[:, -1].reshape(b, s, *ys.shape[2:]).movedim(1, -1)
        self.imshow(ax=self.corr_ax, img=ys_s.mean(-1))
        fs_s = fs.squeeze(1).reshape(b, s, *fs.shape[2:]).movedim(1, -1)
        num_filtered = 0
        if self.G.flow_sample_filter is not None:
            actives = self.active_patches[..., None].repeat(1, 1, s)
            fs_s, fs_mask = self.G.flow_sample_filter(fs_s, actives)
            num_filtered = int(fs_mask.sum())
        self.flow_samples_list.extend(
            [fs_s[..., k][:, None] for k in range(s)])
        if self._normalize_flow_magnitude:
            self.flow2rgb.max_speed = float(
                torch.sqrt((fs_s ** 2).sum(1)).max())
        flow_rgbs = torch.stack(
            [self.flow2rgb(fs_s[..., k]) for k in range(s)], -1).sum(-1)
        self.imshow(ax=self.flow_ax, img=flow_rgbs)
        mag = torch.sqrt((fs_s ** 2).sum(1, keepdim=True)).mean(-1)
        mag = mag - mag.amin((-2, -1), keepdim=True)
        mag = mag / torch.clamp(mag.amax((-2, -1), keepdim=True), min=1e-3)
        self.imshow(ax=self.seg_ax, img=self.get_input()[:, 0] * mag)
        if self.flow_ax is not None:
            self.flow_ax.set_title('filtered %d / %d samples'
                                   % (num_filtered, s))

    def _run_error_maps(self):
        mask = self.active_patches & self.passive_patches
        extra = ({'static_head_motion': self.static_head_motion,
                  'mask_head_motion': False}
                 if hasattr(self.G, '_get_head_motion') else {})
        error_dict = self.G.get_error_maps(x=self._x, mask=mask, **extra)
        if self.flow_ax is not None:
            self.G.flowshow(error_dict['flow_true'][:, 0], ax=self.flow_ax,
                            set_max_speed=True, title='true flow')
        if self.seg_ax is not None:
            self.G.flowshow(error_dict['flow_pred'][:, 0], ax=self.seg_ax,
                            set_max_speed=False, title='pred flow')
        self.show_flow_error(error_dict['flow_error'])
        self._show_flow = True

    def _run_patch_selector(self):
        if self.patch_selector is None:
            self.text.set_text('no patch selector configured')
            return
        self.text.set_text('running patch selector...')
        x = self._x if self._x.dim() == 5 else self._x[:, None]
        x2 = x[:, -1:].expand(x.shape[0], 2, *x.shape[2:])
        fs, actives, passives = self.patch_selector(
            x2, init_actives=self.active_patches,
            init_passives=self.passive_patches)
        self.flow_samples_list.extend(
            [fs[..., k][:, None] for k in range(fs.shape[-1])])
        # mean of per-sample magnitudes (the selector's own statistic):
        # opposite-direction shifts cancel in a mean-then-magnitude
        affs, _, _ = self.patch_selector.compute_affinity_targets_from_samples(
            fs)                                  # [B, H, W]
        img = self.G.get_masked_pred_patches(x2, actives.all(-1),
                                             fill_value=[0, 1, 1])
        img = self.G.get_masked_pred_patches(img, passives.all(-1),
                                             fill_value=[1, 0, 1])
        self.imshow(img=img[:, -1], ax=self.corr_ax)
        self.imshow(img=affs, ax=self.flow_ax, cmap='RdBu_r', vmin=0, vmax=1)
        self.imshow(img=x2[:, -1] * affs[:, None], ax=self.seg_ax)

    # ------------------------------------------------------------------
    def sample_random_patches(self, num_samples=10, num_visible=1):
        return self.G.sample_random_masks(num_samples=num_samples,
                                          num_visible=num_visible)

    def get_random_flow_samples(self, num_samples=10, num_active_patches=1,
                                num_passive_patches=0, **kwargs):
        active = self.sample_random_patches(num_samples, num_active_patches)
        passive = self.sample_random_patches(num_samples,
                                             num_passive_patches)
        kw = copy.deepcopy(self._model_kwargs)
        kw.update(kwargs)
        b = self._x.shape[0]
        ys, flow_samples = self.G.predict_counterfactual_videos_and_flows(
            self._x, active_patches=active, passive_patches=passive,
            shifts=None, num_samples=num_samples,
            sample_batch_size=num_samples,
            static_head_motion=self.static_head_motion, **kw)
        s = flow_samples.shape[0] // b
        return flow_samples[:, 0].reshape(
            b, s, *flow_samples.shape[2:]).movedim(1, -1)

    def _get_corrmat(self, num_samples=10, num_active_patches=1,
                     num_passive_patches=1, downsample=1, resample=False,
                     **kwargs):
        if self._flow_corrs is not None and not resample:
            return self._flow_corrs
        flow_samples = self.get_random_flow_samples(
            num_samples, num_active_patches, num_passive_patches, **kwargs)
        self._flow_corrs = torch.relu(compute_flow_cov(
            flow_samples, downsample=downsample))
        self._num_flow_samples = flow_samples.shape[-1]
        return self._flow_corrs

    def show_random_correlogram(self, i=0, j=0, num_samples=10,
                                num_active_patches=1, num_passive_patches=0,
                                resample=False, batch_size=None, **kwargs):
        if resample or num_samples != self._num_flow_samples:
            self._flow_corrs, self._num_flow_samples = None, None
            batch_size = batch_size or num_samples
            self.flow_samples_list = []
            for _ in range(num_samples // batch_size):
                fs = self.get_random_flow_samples(
                    batch_size, num_active_patches, num_passive_patches,
                    **kwargs)
                self.flow_samples_list.extend(
                    [fs[..., k][:, None] for k in range(fs.shape[-1])])
        self.show_corrmat_segment(i, j, downsample=self._covmat_downsample)

    def visualize_correlogram(self, num_points=4, inds_list=(),
                              use_stored_inds=True, num_samples=10,
                              num_active_patches=1, num_passive_patches=1,
                              power=1, resample=False, overlay=False,
                              marker_color=(1, 0, 1), **kwargs):
        """Gallery of covariance rows at chosen points, in a new matplotlib
        figure."""
        import matplotlib.pyplot as plt
        corrmat = self._get_corrmat(num_samples, num_active_patches,
                                    num_passive_patches, resample=resample,
                                    downsample=self._covmat_downsample,
                                    **kwargs)
        size = corrmat.shape[-4:-2]
        sh = self.x.shape[-2] // size[-2]
        sw = self.x.shape[-1] // size[-1]

        points = list(inds_list)[-num_points:]
        if use_stored_inds and len(points) < num_points:
            points.extend(
                self._corrmat_inds_list[-(num_points - len(points)):])
        while len(points) < num_points:
            points.append([int(self.rng.randint(0, size[0] * sh)),
                           int(self.rng.randint(0, size[1] * sw))])

        # ceil: num_points // 2 rows would be too few for odd num_points
        n_rows = max(2, -(-num_points // 2))
        n_cols = 2 if overlay else 4
        fig, axes = plt.subplots(n_rows, n_cols,
                                 figsize=(4 * n_cols, n_rows * 4))
        for idx, p in enumerate(points):
            row, col = idx // 2, idx % 2
            pi, pj = (p[0] // self.G.patch_size[-2],
                      p[1] // self.G.patch_size[-1])
            corr_img = corrmat[:, :, p[0] // sh, p[1] // sw]
            corr_img = corr_img - corr_img.amin((-2, -1), keepdim=True)
            corr_img = corr_img / torch.clamp(
                corr_img.amax((-2, -1), keepdim=True), min=1e-3)
            corr_img = corr_img ** power
            marker_mask = self.G.generate_mask_from_patch_idx_list(
                [[pi, pj]], stride=1)  # (pi, pj) are patch coordinates
            img = self.G.get_masked_pred_patches(
                self.G.x, marker_mask, fill_value=list(marker_color))[:, 1]
            if overlay:
                # one panel per point: the marker image modulated by the
                # covariance row resized to it
                ci = resize_bilinear(corr_img, img.shape[-2:])
                imshow(img * ci, ax=axes[row, col])
                cells = (axes[row, col],)
            else:
                imshow(img, ax=axes[row, col * 2])
                imshow(corr_img, ax=axes[row, col * 2 + 1])
                cells = (axes[row, col * 2], axes[row, col * 2 + 1])
            for a in cells:
                a.set_xticks([])
                a.set_yticks([])
        plt.tight_layout()
        return points
