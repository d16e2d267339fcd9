"""IMU-aware generators: predict IMU from video, and condition the masked
predictor on an IMU context.

Port of counterfactualworldmodels_tpu/pipelines/imu.py. The two-model
pipeline:

1. flow2imu (a ConjoinedVMAE whose main stream reads RAFT forward and
   backward flow + RGB) predicts the IMU of a frame pair; run on a static
   movie it gives the "no head motion" IMU embedding;
2. the IMU-conditioned predictor (a padded ConjoinedVMAE) reads RGB
   patches with that IMU as its context stream, for counterfactuals.

Routing is decided BEFORE an engine runs: a counterfactual chunk or a
``predict`` goes to the conjoined shared-prefix engine
(models/fast_conjoined.py) when the engine is 'fast', the model is one it
supports (``conjoined_fast_supported``) and the prompt fits it (one scene,
fix_passive, frame 0 visible, the IMU context fully visible); otherwise
that call takes the exact path. There is no fallback after a failure: an
exception inside the engine reaches the caller. Kernels run because the
tensors are on the card (K1 in the exact models' blocks and the prefix,
K2 in the suffix decoder, the window lookup in every RAFT iteration), and
their plain versions run on the CPU.

Every draw goes through the generator's ``_draw_*`` methods
(``_draw_stream_mask`` for the stream mask generators' masks), so tests
can put the JAX draws in their place.
"""
from __future__ import annotations

import torch

from ..masking import generators as maskgen
from ..models import fast_conjoined
from ..models.conjoined import ConjoinedPredictorWrapper
from ..models.fast_vmae import resolve_two_source, sfx_bucket
from ..models.raft.raft import apply_raft_shared0, apply_raft_video
from ..ops.normalization import imagenet_normalize, imagenet_unnormalize
from . import perturbation as perturb
from .prediction import make_counterfactuals, scatter_pred_patches
from .segmentation import FlowGenerator, _rect_noise


@torch.no_grad()
def _conjoined_predict_video(wrapper: ConjoinedPredictorWrapper, x, mask,
                             x_context, mask_context, n_vis: int,
                             n_vis_c: int, normalize: bool):
    """The exact conjoined prediction of a video: preprocess -> two-stream
    forward -> the masked tokens' predictions scattered into the input.
    x [B, T, C, H, W]; n_vis counts the REAL visible main tokens (nulls
    excluded); n_vis_c the full context visible count (dummy or null
    tokens included)."""
    xm = imagenet_normalize(x, temporal_dim=1) if normalize else x
    (x_m, mask_m), (x_c, mask_c) = wrapper.get_stream_inputs(
        xm.transpose(1, 2), mask, x_context, mask_context)
    main = wrapper.model.main
    n_vis_pad = n_vis + (main.min_padding_tokens if main.padded else 0)
    y = wrapper.model(x_m, mask_m, x_c, mask_c, n_vis_pad, n_vis_c,
                      output_main=True, output_context=False)
    y = y[:, :main.num_patches - n_vis]
    return scatter_pred_patches(y, x, mask, n_vis, wrapper.patch_size)


def _imu_tokens_to_stream(y, pt: int):
    """[B, T, pt*c] IMU tokens -> the [B, c, T*pt] channel-major stream
    (einops 'b t (pt c) -> b c (t pt)'), on y's device."""
    b, t, _ = y.shape
    c = y.shape[-1] // pt
    return y.reshape(b, t, pt, c).permute(0, 3, 1, 2).reshape(b, c, t * pt)


def _imu_sfx_pad(wrapper, n_vis: int) -> int:
    """The bucketed suffix width of the conjoined engine: sfx_bucket over
    the frame-1 visible count, NOT the raw n_vis (which would overflow
    pad_vis1_idx on every prompt with frame 0 visible)."""
    m = wrapper.model.main
    n0 = m.num_patches // m.num_frames
    return sfx_bucket(n_vis - n0, m.num_patches - n0)


class ImuGenerator(FlowGenerator):
    """Wraps a conjoined predictor whose context stream is IMU: predicts
    the IMU of a video (its context-stream outputs)."""

    def __init__(self, *args, head_mask_generator=None, head_mask_ratio=0,
                 always_use_predicted=False, require_none_missing=False,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if not isinstance(self.predictor, ConjoinedPredictorWrapper):
            raise TypeError(f'{type(self).__name__} wraps a conjoined '
                            'two-stream predictor (ConjoinedPredictorWrapper)')
        self._check_device(self.predictor.model, 'predictor')
        self.num_head_tokens = self.predictor.num_head_tokens
        if self.mask_generator is None:
            t, h, w = self.predictor.mask_size
            self.mask_generator = maskgen.MaskingGenerator(
                input_size=(t, h, w), mask_ratio=0, always_batch=True,
                device=self.device)
        if head_mask_generator is not None:
            self.head_mask_generator = head_mask_generator
        else:
            self.set_head_mask_generator()
            self.head_mask_generator.mask_ratio = head_mask_ratio
        self._always_use_predicted = always_use_predicted
        self._require_none_missing = require_none_missing
        self.missing_imu = None

    @property
    def head_tubelet_size(self):
        return self.predictor.model.context.imu_tubelet

    @property
    def head_motion_channels(self):
        return self.predictor.model.context.in_chans

    def set_head_mask_generator(self):
        """(Re)build the default head-motion mask generator."""
        self.head_mask_generator = maskgen.MissingDataImuMaskGenerator(
            input_size=self.num_head_tokens, mask_ratio=0,
            full_mask_prob=0, full_vis_prob=0, truncation_mode='none',
            device=self.device)

    def set_head_mask_params(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self.head_mask_generator, k, v)

    def set_mode(self, mode='output'):
        if mode not in ('output', 'input'):
            raise ValueError('%s is not a known mode' % mode)
        self.set_head_mask_params(mask_ratio=1.0 if mode == 'output' else 0.0)

    def input_mode(self):
        self.set_mode('input')

    def output_mode(self):
        self.set_mode('output')

    def reshape_input(self, x, tubelet_size=None):
        """[B, c, T*pt] -> [B, T, pt*c] ('b c (t pt) -> b t (pt c)')."""
        pt = tubelet_size or self.head_tubelet_size
        x = self._tensor(x)
        b, c, l = x.shape
        return x.reshape(b, c, l // pt, pt).permute(0, 2, 3, 1).reshape(
            b, l // pt, pt * c)

    def reshape_output(self, y, tubelet_size=None):
        return _imu_tokens_to_stream(self._tensor(y),
                                     tubelet_size or self.head_tubelet_size)

    def predict(self, x=None, mask=None, frame=None, x_context=None,
                mask_context=None, **kwargs):
        """Factual main-stream prediction through the conjoined wrapper,
        with the IMU context (default: zeroed and fully masked). The main
        stream must read the raw video."""
        x = self._tensor(self.x if x is None else x)
        if x.dim() == 4:
            x = x[:, None]
        w = self.predictor
        if w.model.main.in_chans != x.shape[2]:
            raise TypeError(
                f'{type(self).__name__}.predict reconstructs the main stream '
                'into the input video, which requires the conjoined main '
                f'stream to consume the raw video (model in_chans '
                f'{w.model.main.in_chans} != input channels {x.shape[2]}); '
                'use predict_imu / predict_imu_from_video instead')
        x, mask, n_vis = self._prepare(x, mask)
        b = x.shape[0]
        if x_context is None:
            x_context = torch.zeros(
                (b, self.head_motion_channels,
                 self.head_tubelet_size * self.num_head_tokens),
                device=self.device)
            if mask_context is None:
                mask_context = torch.ones((b, self.num_head_tokens),
                                          dtype=torch.bool,
                                          device=self.device)
        if mask_context is None:
            mask_context = torch.zeros((b, self.num_head_tokens),
                                       dtype=torch.bool, device=self.device)
        mask_context = self._tensor(mask_context)
        vid = _conjoined_predict_video(
            w, x, mask, self._tensor(x_context), mask_context, n_vis,
            w.context_n_vis(mask_context), self.imagenet_normalize_inputs)
        if frame is not None:
            f = frame % vid.shape[1]
            vid = vid[:, f:f + 1]
        return vid

    def _counterfactual_chunk(self, *args, **kwargs):
        raise TypeError(
            'ImuGenerator wraps a conjoined predictor for IMU prediction '
            '(predict_imu / predict); for IMU-conditioned counterfactuals use '
            'ImuConditionedFlowGenerator')

    def _context_outputs(self, x, mask, imu, imu_mask):
        """The context-stream predictions of every masked IMU token, in
        order [B, M, pt*c]. x: [B, C, T, H, W]."""
        xm = self._tensor(x)
        if self.imagenet_normalize_inputs:
            xm = imagenet_normalize(xm, temporal_dim=2)
        return self.predictor(xm, mask, x_context=imu, mask_context=imu_mask,
                              output_main=False, output_context=True)

    def get_imu_input(self, inp_dict, imu_mode='input', missing_thresh=0.5):
        """A dataset example unpacked into the model's IMU inputs:
        [video_unnormalized, imu, missing_imu, imu_mask, timestamps];
        ``imu_mode`` sets the head mask ratio ('input': IMU visible,
        'output': fully masked). Videos are time-first [B, T, C, H, W]."""
        if imu_mode is not None:
            self.set_mode(imu_mode)
        video = self._tensor(inp_dict['video'])
        imu = self._tensor(inp_dict['imu'])
        add_batch = imu.dim() != 3
        if add_batch:
            video, imu = video[None], imu[None]
        missing = inp_dict.get('imu_missing_data')
        missing = (torch.zeros(imu.shape, dtype=torch.bool,
                               device=self.device) if missing is None
                   else self._tensor(missing))
        if add_batch and missing.dim() == imu.dim() - 1:
            missing = missing[None]
        x = imagenet_unnormalize(video, temporal_dim=1)
        if self.t_dim == 2:
            # the IMU to the context stream's channel-first [B, D, L]
            imu = imu.transpose(1, 2)
        missing_tok = missing.reshape(missing.shape[0], self.num_head_tokens,
                                      -1)
        missing_frac = missing_tok.float().mean(-1) > missing_thresh
        imu_mask = self._draw_stream_mask(self.head_mask_generator,
                                          missing_frac)
        ts = inp_dict.get('video_ts')
        if ts is not None:
            ts = self._tensor(ts)
            if add_batch and ts.dim() == 1:
                ts = ts[None]
        return [x, imu, missing_tok, imu_mask, ts]

    def predict_imu(self, inp_dict, imu_mask_ratio=1, get_labels=True,
                    missing_thresh=0.5, **kwargs):
        """IMU tokens predicted from video: the predictions at masked
        tokens, the truth at visible ones. inp_dict: {'video': [B, C, T, H,
        W] (normalized per the wrapper), 'imu': [B, 6, L],
        'imu_missing_data': [B, 6, L] bool-ish}."""
        video = self._tensor(inp_dict['video'])
        imu = self._tensor(inp_dict['imu'])
        missing = inp_dict.get('imu_missing_data')
        missing = (torch.zeros(imu.shape, dtype=torch.bool,
                               device=self.device) if missing is None
                   else self._tensor(missing))
        b = video.shape[0]
        # a raw view of the channel-major [B, 6, L] array (not the token
        # layout), as the reference reads it
        missing_tok = missing.reshape(b, self.num_head_tokens, -1)
        self.missing_imu = missing_tok
        missing_frac = missing_tok.float().mean(-1) > missing_thresh
        self.set_head_mask_params(mask_ratio=imu_mask_ratio)
        imu_mask = self._draw_stream_mask(self.head_mask_generator,
                                          missing_frac)
        if imu_mask_ratio == 1:
            imu_mask = torch.ones_like(imu_mask)
        self.mask = self._draw_stream_mask(self.mask_generator, video)
        y_c = self._context_outputs(
            video.transpose(1, 2) if video.shape[1] != 3 else video,
            self.mask, imu, imu_mask)

        labels = self.reshape_input(imu)
        m = self.predictor.model.context
        pad = torch.zeros((b, m.max_padding_tokens if m.padded else 0),
                          dtype=torch.bool, device=self.device)
        order = torch.argsort(torch.cat([imu_mask, pad], -1).to(torch.uint8),
                              dim=-1, stable=True).cpu()
        n_vis = int((~imu_mask).sum(-1).max()) + (
            m.min_padding_tokens if m.padded else 0)
        pred = labels.clone()
        for bi in range(b):
            masked = [int(i) for i in order[bi, n_vis:] if i < m.num_patches]
            pred[bi, masked] = y_c[bi, :len(masked)].to(pred.dtype)
        return (pred, labels) if get_labels else pred

    @property
    def any_imu(self):
        if self.missing_imu is None:
            return None
        return ~self.missing_imu.bool().flatten(1).all(-1)

    @property
    def full_imu(self):
        if self.missing_imu is None:
            return None
        return ~self.missing_imu.bool().flatten(1).any(-1)

    def __call__(self, inp_dict, imu_mask_ratio=1, **kwargs):
        """The predicted IMU where it is missing, the true IMU where it is
        present: (imu tokens, missing)."""
        pred, labels = self.predict_imu(inp_dict,
                                        imu_mask_ratio=imu_mask_ratio,
                                        get_labels=True)
        if self._always_use_predicted:
            out = pred
        elif self._require_none_missing:
            out = torch.where(self.full_imu[:, None, None], labels, pred)
        else:
            out = torch.where(self.any_imu[:, None, None], labels, pred)
        zeros = torch.zeros_like(self.missing_imu)
        if self._always_use_predicted:
            missing = zeros
        else:
            missing = torch.where(self.any_imu[:, None, None],
                                  self.missing_imu, zeros)
        return out, missing

    forward = __call__


class ImuConditionedFlowGenerator(FlowGenerator):
    """The two-model pipeline: the flow2imu head-motion predictor and the
    IMU-conditioned masked predictor (both ConjoinedPredictorWrapper)."""

    def __init__(self, *args, predictor: ConjoinedPredictorWrapper,
                 head_motion_predictor: ConjoinedPredictorWrapper,
                 head_motion_kwargs=None, **kwargs):
        super().__init__(*args, predictor=predictor, **kwargs)
        if not isinstance(predictor, ConjoinedPredictorWrapper):
            raise TypeError('ImuConditionedFlowGenerator needs a '
                            'ConjoinedPredictorWrapper predictor')
        self._check_device(predictor.model, 'predictor')
        hm_kwargs = dict(head_motion_kwargs or {})
        hm_kwargs.setdefault('imagenet_normalize_inputs',
                             self.imagenet_normalize_inputs)
        hm_kwargs.setdefault('flow_model', self.flow_model)
        hm_kwargs.setdefault('flow_params', self.flow_params)
        hm_kwargs.setdefault('device', self.device)
        self.head_motion_generator = ImuGenerator(
            predictor=head_motion_predictor, head_mask_ratio=1, **hm_kwargs)
        self._conj_prefix_lru = None   # built on the first fast call
        self._conj_params_src = None   # identity key: rebuilt on a swap
        self._conj_params = None
        self._x_context = self._mask_context = None

    @property
    def num_head_tokens(self):
        return self.head_motion_generator.num_head_tokens

    @property
    def head_tubelet_size(self):
        return self.head_motion_generator.head_tubelet_size

    @property
    def head_motion_channels(self):
        return self.head_motion_generator.head_motion_channels

    def get_fake_head_motion(self, x):
        """Zeroed IMU and a fully masked IMU mask."""
        b = x.shape[0]
        hm = torch.zeros((b, self.head_motion_channels,
                          self.head_tubelet_size * self.num_head_tokens),
                         device=self.device)
        return hm, torch.ones((b, self.num_head_tokens), dtype=torch.bool,
                              device=self.device)

    def predict_imu_from_video(self, x, timestamps=None):
        """The flow2imu forward. x: [B, T, C, H, W] raw [0, 1] video.
        Returns the predicted IMU tokens [B, M, pt*c]."""
        x = self._tensor(x)
        fake_imu, imu_mask = self.get_fake_head_motion(x)
        g = self.head_motion_generator
        mask = self._draw_stream_mask(g.mask_generator, x)
        xm = (imagenet_normalize(x, temporal_dim=1)
              if g.imagenet_normalize_inputs else x)
        return g.predictor(xm.transpose(1, 2), mask, x_context=fake_imu,
                           mask_context=imu_mask, output_main=False,
                           output_context=True)

    def get_static_imu(self, x=None, timestamps=None):
        """The predicted IMU of a static scene: frame 0 repeated."""
        x = self._tensor(self.x if x is None else x)
        static = x[:, 0:1].expand(-1, x.shape[1], -1, -1, -1)
        return self.predict_imu_from_video(static, timestamps=timestamps)

    def get_zeros_imu(self, x=None, timestamps=None):
        """Zeros in predict_imu_from_video's [B, M, pt*c] layout (its shape
        is static from the head model's config)."""
        x = self.x if x is None else x
        return torch.zeros((x.shape[0], self.num_head_tokens,
                            self.head_tubelet_size
                            * self.head_motion_channels),
                           device=self.device)

    def reshape_output(self, y, tubelet_size=None):
        return _imu_tokens_to_stream(self._tensor(y),
                                     tubelet_size or self.head_tubelet_size)

    def _get_head_motion(self, x, head_motion=None, static_head_motion=True,
                         timestamps=None):
        if head_motion is not None:
            return self._tensor(head_motion)
        self.set_input(x)
        if static_head_motion:
            return self.get_static_imu(timestamps=timestamps)
        return self.predict_imu_from_video(self.x, timestamps=timestamps)

    def _clear_fast_state(self):
        """Also drop the conjoined engine's state (the cast weights and the
        per-(scene, IMU) prefix LRU)."""
        super()._clear_fast_state()
        self._conj_prefix_lru = None
        self._conj_params_src = None
        self._conj_params = None

    def _ensure_conj_fast(self):
        """The engine's state, built on first use and rebuilt when the
        predictor's weights are replaced: the weights cast once to the
        model's compute dtype, and the prefix LRU."""
        w = self.predictor
        if (self._conj_prefix_lru is None
                or self._conj_params_src is not w.params):
            self._conj_params_src = w.params
            self._conj_params = fast_conjoined.cast_params(
                w.model, w.params, w.model.dtype, self.device)
            self._conj_prefix_lru = fast_conjoined.ConjoinedPrefixLru(
                w, self._conj_params, self._use_flash,
                self.imagenet_normalize_inputs, size=self.prefix_cache_size)

    def _conj_fast_ok(self, prompt_ok: bool) -> bool:
        """The engine runs a call when it is on, supports the model and the
        prompt fits it (prompt_ok: the caller's shape gate)."""
        return (self.engine == 'fast' and prompt_ok
                and fast_conjoined.conjoined_fast_supported(
                    self.predictor.model))

    def predict(self, x=None, mask=None, frame=-1, x_context=None,
                mask_context=None, static_head_motion=True,
                mask_head_motion=False, **kwargs):
        """Factual prediction with the IMU context. With no x_context the
        head motion is predicted (``static_head_motion``: the static scene
        embedding, else the video's); ``mask_head_motion`` masks it fully.
        One two-frame scene with frame 0 visible and a visible context runs
        on the shared-prefix engine with the prefix LRU."""
        x = self._tensor(self.x if x is None else x)
        if x.dim() == 4:
            x = x[:, None]
        x, mask, n_vis = self._prepare(x, mask)
        if x_context is None:
            x_context = self.reshape_output(self._get_head_motion(
                x, static_head_motion=static_head_motion))
        x_context = self._tensor(x_context)
        if mask_context is None:
            mask_context = torch.full((x.shape[0], self.num_head_tokens),
                                      bool(mask_head_motion),
                                      device=self.device)
        mask_context = self._tensor(mask_context)
        w = self.predictor
        n0 = w.model.main.num_patches // w.model.main.num_frames
        if self._conj_fast_ok(x.shape[0] == 1 and x.shape[1] == 2
                              and not bool(mask[:, :n0].any())
                              and not bool(mask_context.any())):
            self._ensure_conj_fast()
            cache, _ = self._conj_prefix_lru.get(x, x_context)
            vid = fast_conjoined.predict_videos_conjoined_prefix(
                w, self._conj_params, x, mask, x_context, mask_context, n_vis,
                self.imagenet_normalize_inputs, self._use_flash, cache=cache)
        else:
            vid = _conjoined_predict_video(
                w, x, mask, x_context, mask_context, n_vis,
                w.context_n_vis(mask_context), self.imagenet_normalize_inputs)
        if frame is not None:
            f = frame % vid.shape[1]
            vid = vid[:, f:f + 1]
        return vid

    def predict_imu_video_and_flow(self, x, mask=None, timestamps=None,
                                   head_motion=None, mask_head_motion=False,
                                   static_head_motion=False,
                                   return_head_motion=False, **kwargs):
        """Predict the head motion, then the IMU-conditioned video and its
        flow."""
        self.set_input(x)
        self.mask = (self.generate_mask(self.x) if mask is None
                     else self._tensor(mask))
        h = self._get_head_motion(self.x, head_motion, static_head_motion,
                                  timestamps)
        if return_head_motion:
            return h
        h_mask = torch.full((h.shape[0], self.num_head_tokens),
                            bool(mask_head_motion), device=self.device)
        y = self.predict(self.x, self.mask, frame=None,
                         x_context=self.reshape_output(h),
                         mask_context=h_mask)
        return y, self.predict_flow(y)

    def predict_counterfactual_videos_and_flows(self, x, *args,
                                                head_motion=None,
                                                timestamps=None,
                                                mask_head_motion=False,
                                                static_head_motion=True,
                                                **kwargs):
        """The central API with the IMU context: the head motion (given, or
        predicted) conditions every counterfactual."""
        # [B, 2, C, H, W] BEFORE set_input, so the head motion sees a
        # two-frame movie
        x = self._tensor(x)
        if x.dim() == 3:
            x = x[None, None].expand(1, 2, *x.shape)
        elif x.dim() == 4:
            x = x[:, None].expand(x.shape[0], 2, *x.shape[1:])
        elif x.dim() == 5 and x.shape[1] == 1:
            x = x.expand(x.shape[0], 2, *x.shape[2:])
        self.set_input(x)
        h = self._get_head_motion(self.x, head_motion, static_head_motion,
                                  timestamps)
        self._x_context = self.reshape_output(h)
        self._mask_context = torch.full((h.shape[0], self.num_head_tokens),
                                        bool(mask_head_motion),
                                        device=self.device)
        return super().predict_counterfactual_videos_and_flows(x, *args,
                                                               **kwargs)

    def _counterfactual_chunk(self, x, passive, active, shifts, noise, n_vis,
                              iters, fix_passive):
        """One chunk of prompts with the IMU context: the conjoined
        shared-prefix dispatch with this (scene, IMU) pair's cached prefix
        when the engine takes the prompts (one scene, fix_passive, frame 0
        visible, a visible context), else the exact one."""
        w = self.predictor
        s = passive.shape[-1]
        n0 = w.model.main.num_patches // w.model.main.num_frames
        frame0_clear = not bool((passive[:, :n0] & active[:, :n0]).any())
        if self._conj_fast_ok(x.shape[0] == 1 and fix_passive and frame0_clear
                              and not bool(self._mask_context.any())):
            self._ensure_conj_fast()
            cache, _ = self._conj_prefix_lru.get(x, self._x_context)
            return _imu_counterfactual_step_fast(
                w, self._conj_params, self.flow_model, x, passive, active,
                shifts, noise, self._x_context, self._mask_context, n_vis,
                self.imagenet_normalize_inputs, iters, self._use_flash,
                resolve_two_source(self._use_flash), cache)
        return _imu_counterfactual_step(
            w, self.flow_model, x, passive, active, shifts, noise,
            self._x_context.repeat_interleave(s, 0),
            self._mask_context.repeat_interleave(s, 0), n_vis,
            w.context_n_vis(self._mask_context),
            self.imagenet_normalize_inputs, iters, fix_passive,
            x.shape[0] == 1 and fix_passive and frame0_clear)


def _imu_counterfactual_step_fast(wrapper, params, raft_model, x, passive,
                                  active, shifts, noise, x_context,
                                  mask_context, n_vis: int, normalize: bool,
                                  raft_iters: int, use_flash: bool,
                                  two_source: bool, prefix_cache=None):
    """The shared-prefix step for one scene: B = 1, fix_passive, frame 0
    visible, the IMU context [1, C, L] shared and visible (untiled). The
    conjoined forward runs on models/fast_conjoined.py (prefix_cache:
    this (scene, IMU) pair's make_conjoined_prefix_cache, which skips the
    prefix pass) and RAFT shares the frame-0 encoders across samples.
    x [1, T, C, H, W]; passive/active bool [1, N, S]; shifts int [1, S, 2];
    noise [1, S, N1] rectangularizer draws (or a torch.Generator). Returns
    (videos [S, T, C, H, W], flows [S, 1, 2, H, W], masks [S, N])."""
    if x.shape[0] != 1:
        raise ValueError(
            f'fast path is per-scene (B == 1), got B={x.shape[0]}')
    m = wrapper.model.main
    n0 = m.num_patches // m.num_frames
    s = passive.shape[-1]
    noise = _rect_noise(noise, s, m.num_patches - n0, x.device)
    x_mocos, mask_mocos = perturb.make_motion_counterfactual(
        x[0], passive[0].T, active[0].T, shifts[0], noise, wrapper.patch_size,
        n_vis_target=n_vis, fix_passive=True)
    y = fast_conjoined._conjoined_videos_core(
        wrapper, params, x_mocos, mask_mocos, x_context, mask_context,
        _imu_sfx_pad(wrapper, n_vis), normalize, use_flash, two_source,
        prefix_cache)
    flows = apply_raft_shared0(raft_model, y, raft_iters, True)
    return y, flows, mask_mocos


def _imu_counterfactual_multi_step_fast(wrapper, params, raft_model, x,
                                        passive, active, shifts, noise,
                                        x_context, mask_context, n_vis: int,
                                        normalize: bool, raft_iters: int,
                                        use_flash: bool, two_source: bool,
                                        prefix_cache):
    """The multi-SCENE step: each sample carries its OWN (scene, IMU) pair.
    x [S, T, C, H, W]; passive/active bool [S, N]; shifts int [S, 2];
    noise [S, N1]; x_context [S, C, L]; mask_context [S, M] all False;
    prefix_cache a REQUIRED stacked cache
    (fast_conjoined.stack_conjoined_prefix_caches, scene i at row i). RAFT
    runs every sample's pair (frame 0 differs per sample)."""
    if prefix_cache is None:
        raise ValueError('the multi-scene step needs the stacked per-sample '
                         'prefix cache')
    m = wrapper.model.main
    n0 = m.num_patches // m.num_frames
    noise = _rect_noise(noise, x.shape[0], m.num_patches - n0, x.device)
    x_mocos, mask_mocos = perturb.make_motion_counterfactual(
        x, passive, active, shifts, noise, wrapper.patch_size,
        n_vis_target=n_vis, fix_passive=True)
    y = fast_conjoined._conjoined_videos_core(
        wrapper, params, x_mocos, mask_mocos, x_context, mask_context,
        _imu_sfx_pad(wrapper, n_vis), normalize, use_flash, two_source,
        prefix_cache)
    flows = apply_raft_video(raft_model, y, iters=raft_iters,
                             scale_inputs=True)
    return y, flows, mask_mocos


def _imu_counterfactual_step(wrapper, raft_model, x, passive, active, shifts,
                             noise, x_context, mask_context, n_vis: int,
                             n_vis_c: int, normalize: bool, raft_iters: int,
                             fix_passive: bool, shared0_ok: bool = False):
    """The exact step: prompts -> the exact conjoined forward
    (IMU-conditioned; the context pre-tiled over the B*S samples) -> RAFT.
    shared0_ok: the CALLER asserts that every sample's frame 0 is the same
    (one scene, fix_passive and no frame-0 patch masked); only then does
    RAFT share the frame-0 encoder passes."""
    b, s = x.shape[0], passive.shape[-1]
    npf = wrapper.num_patches // wrapper.num_frames
    noise = _rect_noise(noise, b * s, npf, x.device).reshape(b, s, npf)
    x_mocos, mask_mocos = make_counterfactuals(
        x, passive, active, shifts, noise, wrapper.patch_size, n_vis,
        fix_passive=fix_passive)
    y = _conjoined_predict_video(wrapper, x_mocos, mask_mocos, x_context,
                                 mask_context, n_vis, n_vis_c, normalize)
    if shared0_ok and b == 1 and fix_passive:
        flows = apply_raft_shared0(raft_model, y, raft_iters, True)
    else:
        flows = apply_raft_video(raft_model, y, False, raft_iters, True)
    return y, flows, mask_mocos

