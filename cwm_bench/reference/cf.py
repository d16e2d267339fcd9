"""The output check of a counterfactual dispatch.

``prompt_video`` builds what a prompt shows the predictor (the scene in
both frames, the active patch moved by its shift in frame 1) and which
frame-1 patches it shows. ``judge`` holds the program's videos and flows
for some samples against the plain VMAE (reference/vmae.py) on the same
prompts and the plain RAFT (reference/raft.py), and returns the numbers
compared:

- ``pred_rel_err``: over the samples, the largest relative L2 gap of the
  predicted (masked) frame-1 pixels;
- ``flow_gap_bf16x``: over the samples, the largest relative L2 gap of
  the flow against the plain RAFT run on the program's videos, which
  judges the program's RAFT alone, in units of the gap that bfloat16
  operands (precision.BF16) give the plain RAFT: the relative L2 gap over
  all judged samples of the plain RAFT in BF16 against the same in F32,
  both on the plain VMAE's videos. How far 24 iterations carry a rounding
  depends on the seed's weights; the unit takes that out;
- ``flow_full_gap_bf16x``: the same against the plain RAFT run on the
  plain VMAE's videos, the reference's whole chain;
- ``copy_max_abs``: the largest gap where the video shows the input
  (frame 0 and the visible frame-1 patches), which the program copies.

``control_outputs`` gives the same outputs from the reference computed in
float8 (precision.FP8), which stands in for the program in the control.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .precision import BF16, F32, FP8, f32_mode
from .raft import RAFT
from .vmae import RefVMAE, normalize, patches_to_frame

RAFT_BLOCK = 16
VMAE_BLOCK = 8


def prompt_video(scene, active, passive, shifts, v: Dict):
    """scene [3, H, W]; active [R]; passive [R, P]; shifts [R, 2] ->
    (video [R, 2, 3, H, W], visible [R, P + 1] sorted frame-1 indices,
    masked bool [R, grid^2])."""
    p, g = v['patch_size'], v['img_size'] // v['patch_size']
    r = active.shape[0]
    cells = scene.reshape(3, g, p, g, p).permute(1, 3, 0, 2, 4).reshape(
        g * g, 3, p, p)
    target = active + shifts[:, 0] * g + shifts[:, 1]
    f1 = cells[None].repeat(r, 1, 1, 1, 1)
    f1[torch.arange(r, device=scene.device), target] = cells[active]
    f1 = f1.reshape(r, g, g, 3, p, p).permute(0, 3, 1, 4, 2, 5).reshape(
        r, 3, g * p, g * p)
    video = torch.stack([scene[None].expand(r, -1, -1, -1), f1], dim=1)
    visible = torch.cat([passive, target[:, None]], dim=1).sort(dim=1).values
    masked = torch.ones(r, g * g, dtype=torch.bool, device=scene.device)
    masked.scatter_(1, visible, False)
    return video, visible, masked


def _pixel_mask(masked, v: Dict):
    p = v['patch_size']
    g = v['img_size'] // p
    m = masked.reshape(-1, g, g)
    return m.repeat_interleave(p, 1).repeat_interleave(p, 2)[:, None]


def predicted_videos(ref: RefVMAE, rung: Dict, scene, video, visible,
                     masked) -> torch.Tensor:
    """The reference's output video: the input where it is shown, the
    prediction at the masked frame-1 patches."""
    v = ref.v
    cache = ref.prefix(normalize(scene)[None])
    out = []
    for i in range(0, video.shape[0], VMAE_BLOCK):
        sl = slice(i, i + VMAE_BLOCK)
        pred = ref.frame1(cache, normalize(video[sl, 1]), visible[sl],
                          rung['prefix_pool'], rung['suffix_pool'],
                          rung['gelu'])
        f1 = torch.where(_pixel_mask(masked[sl], v),
                         patches_to_frame(pred, v), video[sl, 1])
        out.append(torch.stack([video[sl, 0], f1], dim=1))
    return torch.cat(out)


def raft_flows(raft: RAFT, video) -> torch.Tensor:
    """[R, 2, H, W] flow from frame 0 (shared, the first row's) to each
    row's frame 1; video in [0, 1]."""
    x1 = 255.0 * video[0:1, 0].float()
    out = [raft(x1, 255.0 * video[i:i + RAFT_BLOCK, 1].float())
           for i in range(0, video.shape[0], RAFT_BLOCK)]
    return torch.cat(out)


def _gaps(a, b, weight=None):
    """Per sample: the L2 norm of a - b and of b."""
    d, r = (a - b).float(), b.float()
    if weight is not None:
        d, r = d * weight, r * weight
    return d.flatten(1).norm(dim=1), r.flatten(1).norm(dim=1)


def _rel(a, b, weight=None):
    num, den = _gaps(a, b, weight)
    return float((num / den.clamp_min(1e-30)).max())


def build(cfg: Dict, sd_vmae, sd_raft, prec=F32) -> Tuple[RefVMAE, RAFT]:
    r = cfg['raft']
    raft = RAFT(r['corr_levels'], r['corr_radius'], r['iters'])
    raft.load_state_dict(sd_raft, strict=True)
    raft = raft.to(next(iter(sd_raft.values())).device).eval()
    return RefVMAE(sd_vmae, cfg['vmae'], prec), raft.set_precision(prec)


@torch.no_grad()
def judge(cfg: Dict, sd_vmae, sd_raft, prompts, video_p, flow_p
          ) -> Dict[str, float]:
    """prompts: (scene, active, passive, shifts) of the judged rows;
    video_p [R, 2, 3, H, W] and flow_p [R, 2, H, W] the program's."""
    v = cfg['vmae']
    with f32_mode():
        ref, raft = build(cfg, sd_vmae, sd_raft)
        scene, active, passive, shifts = prompts
        video, visible, masked = prompt_video(scene, active, passive,
                                              shifts, v)
        video_r = predicted_videos(ref, cfg['rung'], scene, video, visible,
                                   masked)
        shown = torch.ones_like(video_r[:, :, :1], dtype=torch.bool)
        shown[:, 1] = ~_pixel_mask(masked, v)
        copy_gap = ((video_p.float() - video.float()).abs()
                    * shown).amax()
        pm = _pixel_mask(masked, v).float()
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
def control_outputs(cfg: Dict, sd_vmae, sd_raft, prompts):
    """(video, flow) of the reference in float8 on the judged prompts."""
    with f32_mode():
        ref, raft = build(cfg, sd_vmae, sd_raft, FP8)
        scene, active, passive, shifts = prompts
        video, visible, masked = prompt_video(scene, active, passive,
                                              shifts, cfg['vmae'])
        video_c = predicted_videos(ref, cfg['rung'], scene, video, visible,
                                   masked)
        return video_c, raft_flows(raft, video_c)
