"""Stream preprocessors: the input pipelines of the conjoined models.

Port of counterfactualworldmodels_tpu/models/preprocessor.py. Each
preprocessor is a small config object whose ``__call__`` selects frames
and transforms them (channel ops, RAFT flow, the IMU reshape). The RAFT
that ``FramePairFlow`` runs is a models.raft.raft.RAFT module, which
carries its weights (``flow_params``: a reference-layout state dict loaded
into it with strict=True); on the card every refinement iteration launches
the window-lookup kernel.

Convention: video inputs are [B, C, T, H, W] (temporal_dim=2, the
predictor layout); IMU inputs are [B, C=6, L].
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from ..ops.normalization import imagenet_normalize, imagenet_unnormalize
from ..utils import profiling


class Preprocessor:
    """Select frames and optionally transform them."""
    num_channels: Optional[int] = None

    def __init__(self, frames_list=None, temporal_dim=2, channel_dim=None,
                 preproc_func=None, num_frames=None, num_channels=None,
                 stack=False, **unused):
        if isinstance(frames_list, int):
            frames_list = [frames_list, frames_list + 1]
        self.frames_list = (list(frames_list) if frames_list is not None
                            else None)
        self.temporal_dim = self.t_dim = temporal_dim
        self.channel_dim = self.c_dim = (channel_dim if channel_dim is not None
                                         else (1 if temporal_dim == 2 else 2))
        self.preproc_func = preproc_func or (lambda x: x)
        self.num_frames = num_frames
        if num_channels is not None:
            self.num_channels = num_channels
        self.stack = stack

    def get_num_frames(self):
        if self.stack:
            return 1
        if self.num_frames is None:
            return (len(self.frames_list) if self.frames_list is not None
                    else None)
        return self.num_frames

    def _frames(self, x, frames=None, temporal_dim=None):
        frames = frames if frames is not None else self.frames_list
        dim = temporal_dim if temporal_dim is not None else self.t_dim
        t = x.shape[dim]
        profiling.count('host_sync.frames')
        idx = torch.tensor([f % t for f in frames], device=x.device)
        return torch.index_select(x, dim, idx)

    def get_output_frames(self, y, temporal_dim=None):
        """The output frames of a per-frame tensor (e.g. a mask)."""
        dim = temporal_dim if temporal_dim is not None else self.t_dim
        nf = self.get_num_frames() or y.shape[dim]
        frames = self.frames_list or list(range(y.shape[dim]))
        return self._frames(y, frames[-nf:], temporal_dim)

    def __call__(self, x, timestamps=None, **kwargs):
        if self.frames_list is not None:
            x = self._frames(x)
        x = self.preproc_func(x)
        if self.stack:
            b = x.shape[0]
            x = x.reshape(b, x.shape[1] * x.shape[2], 1, *x.shape[-2:])
        return x


class Noise(Preprocessor):
    """Uniform [0, 1) noise of the (frame-selected) input's shape: the
    draws ``noise`` as given, else from ``generator`` (a fresh pattern per
    call, as the reference's ``torch.rand_like``)."""

    def __init__(self, *args, generator: Optional[torch.Generator] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.generator = generator

    def __call__(self, x, timestamps=None, noise=None, **kwargs):
        if self.frames_list is not None:
            x = self._frames(x)
        if noise is not None:
            return torch.as_tensor(noise, dtype=x.dtype,
                                   device=x.device).reshape(x.shape)
        return torch.rand(x.shape, generator=self.generator, dtype=x.dtype,
                          device=x.device)


class ImagenetNormalize(Preprocessor):
    num_channels = 3

    def __init__(self, unnormalize=False, **kwargs):
        super().__init__(**kwargs)
        func = imagenet_unnormalize if unnormalize else imagenet_normalize
        self.preproc_func = lambda x: func(x, temporal_dim=self.t_dim)


class IMU(Preprocessor):
    """[B, 6, L] IMU stream -> [B, 6, L, 1, 1] pseudo-video."""
    num_channels = 6

    def __init__(self, sequence_length=None, **kwargs):
        kwargs.setdefault('frames_list', None)
        super().__init__(**kwargs)
        self.sequence_length = sequence_length
        self.num_frames = None

    def get_num_frames(self):
        return None

    def __call__(self, imu=None, timestamps=None, **kwargs):
        if imu is None:
            return None
        return self.preproc_func(imu[..., None, None])


class FramePairFlow(Preprocessor):
    """RAFT flow between consecutive frames, optionally with the backward
    flow and the RGB frames concatenated; the flow is normalised by half
    the image size. flow_model: a RAFT module (default: a new large RAFT
    on ``device``); flow_params: weights to load into it."""
    num_channels = 2

    def __init__(self, flow_model=None, flow_params=None, iters=24,
                 backward=False, unnormalize_rgb=True, normalize_flow=True,
                 concat_backward=False, concat_rgb=False, device='cuda',
                 **kwargs):
        super().__init__(**kwargs)
        if flow_model is None:
            from .raft.raft import RAFT
            flow_model = RAFT(iters=iters, device=device)
        if flow_params is not None:
            flow_model.load_state_dict(flow_params, strict=True)
        self.flow_model = flow_model.eval()
        self.flow_params = flow_params
        self.iters = iters
        self.backward = backward
        self.unnormalize_rgb = unnormalize_rgb
        self.normalize_flow = normalize_flow
        self.concat_backward = concat_backward
        self.concat_rgb = concat_rgb
        self.num_channels = 2 + 2 * int(concat_backward) + 3 * int(concat_rgb)
        if self.frames_list is not None:
            self.num_frames = len(self.frames_list) - 1

    def get_num_frames(self):
        if self.num_frames is None:
            return (len(self.frames_list) - 1
                    if self.frames_list is not None else None)
        return self.num_frames

    def _get_flow(self, x, backward):
        """x: [B, C, T, H, W] in [0, 1]. Returns [B, 2, T-1, H, W]."""
        from .raft.raft import apply_raft_video
        flow = apply_raft_video(self.flow_model, x.transpose(1, 2), backward,
                                self.iters, True)
        return flow.transpose(1, 2)

    def __call__(self, x, timestamps=None, **kwargs):
        if self.frames_list is not None:
            x = self._frames(x)
        # a T-frame input yields T-1 flow frames: record it at call time so
        # get_output_frames selects T-1 mask frames
        self.num_frames = x.shape[self.t_dim] - 1
        if self.unnormalize_rgb:
            x = imagenet_unnormalize(x, temporal_dim=self.t_dim)
        outs = [self._get_flow(x, self.backward)]
        if self.concat_backward:
            outs.append(self._get_flow(x, not self.backward))
        if self.concat_rgb:
            rgb = x
            if self.unnormalize_rgb:
                rgb = imagenet_normalize(rgb, temporal_dim=self.t_dim)
            frames = self.frames_list or list(range(x.shape[self.t_dim]))
            outs.append(self._frames(rgb, frames[1:]))
        out = torch.cat(outs, dim=self.c_dim)
        if self.normalize_flow:
            h, w = out.shape[-2:]
            scale = [w, h] * (2 if self.concat_backward else 1)
            if self.concat_rgb:
                scale = scale + [2.0, 2.0, 2.0]
            scale = torch.tensor(scale, dtype=out.dtype,
                                 device=out.device).reshape(1, -1, 1, 1,
                                                            1) / 2.0
            out = out / scale
        return out


RGB02 = partial(Preprocessor, num_channels=3, frames_list=[0, -1])
RGB01 = partial(Preprocessor, num_channels=3, frames_list=[0, 1])
RGB01Stack = partial(Preprocessor, num_channels=6, frames_list=[0, 1],
                     stack=True)
RGB12 = partial(Preprocessor, num_channels=3, frames_list=[1, -1])
RGB012 = partial(Preprocessor, num_channels=3, frames_list=[0, 1, -1])
RGB0 = partial(Preprocessor, num_channels=3, frames_list=[0])
RGB1 = partial(Preprocessor, num_channels=3, frames_list=[1])
Noise1 = partial(Noise, num_channels=3, frames_list=[1])
Flow01 = partial(FramePairFlow, frames_list=[0, 1])
FlowRGB01 = partial(FramePairFlow, frames_list=[0, 1], concat_rgb=True)
Flow = partial(FramePairFlow)
FlowRGB = partial(FramePairFlow, concat_rgb=True)
FlowBackRGB = partial(FramePairFlow, concat_backward=True, concat_rgb=True)
FlowBack01 = partial(FramePairFlow, frames_list=[0, 1], concat_backward=True)
FlowBackRGB01 = partial(FramePairFlow, frames_list=[0, 1],
                        concat_backward=True, concat_rgb=True)

_REGISTRY = {
    'rgb01': RGB01, 'rgb02': RGB02, 'rgb0': RGB0, 'rgb1': RGB1,
    'noise1': Noise1, 'flow01': Flow01, 'flow_rgb01': FlowRGB01,
    'flow': Flow, 'flow_rgb': FlowRGB, 'flowback_rgb': FlowBackRGB,
    'flowback01': FlowBack01, 'flowback_rgb01': FlowBackRGB01,
    'rgb12': RGB12, 'rgb012': RGB012, 'imu': IMU, 'rgb01stack': RGB01Stack,
}


def get_preprocessor(name, temporal_dim=2, unnormalize=True, **kwargs):
    """The registered preprocessor ``name``. ``unnormalize`` prepends an
    imagenet-unnormalize to visual streams (a FramePairFlow has its own
    ``unnormalize_rgb`` and does not apply it)."""
    if unnormalize and 'imu' not in name:
        kwargs['preproc_func'] = \
            lambda x: imagenet_unnormalize(x, temporal_dim=temporal_dim)
    return _REGISTRY[name](temporal_dim=temporal_dim, **kwargs)
