"""Iterative patch selection for Spelke-segment growing.

Port of counterfactualworldmodels_tpu/pipelines/patch_selector.py: starting
from user-selected active patches, alternately (a) sample motion
counterfactuals and (b) extend the active set with the highest-affinity
patch (and the passive set with the lowest-affinity one), where affinity
is the normalized mean counterfactual flow magnitude. It runs on its
generator's device (the card by default).
"""
from __future__ import annotations

import torch

from .._device import resolve_device


class IterativePatchSelector:
    """Grow active/passive patch sets from counterfactual flow agreement.

    Call signature matches the interface hook:
    ``selector(x, init_actives=..., init_passives=...) ->
    (flow_samples [B,2,H,W,S], actives [B,N,S], passives [B,N,S])``.
    """

    def __init__(self, generator, num_iters: int = 3,
                 samples_per_iter: int = 4, num_passive: int = 1,
                 sample_batch_size: int = 8, affinity_power: float = 1.0,
                 do_filter: bool = True):
        self.G = generator
        self.device = resolve_device(generator.device)
        self.num_iters = num_iters
        self.samples_per_iter = samples_per_iter
        self.num_passive = num_passive
        self.sample_batch_size = sample_batch_size
        self.affinity_power = affinity_power
        self.do_filter = do_filter
        self.filter_masks = None

    def compute_affinity_targets_from_samples(self, flow_samples):
        """flow_samples [B, 2, H, W, S] -> (affinity [B, H, W], mags, None).

        Affinity = minmax-normalized mean flow magnitude over samples.
        """
        mags = torch.sqrt((flow_samples ** 2).sum(1))   # [B,H,W,S]
        mean = mags.mean(-1)
        mn = mean.amin((-2, -1), keepdim=True)
        mx = mean.amax((-2, -1), keepdim=True)
        aff = (mean - mn) / torch.clamp(mx - mn, min=1e-6)
        return aff ** self.affinity_power, mags, None

    def _patch_pool(self, aff):
        """Pixel affinity [B,H,W] -> patch-grid affinity [B,h,w]."""
        ph, pw = self.G.patch_size[-2:]
        b, h, w = aff.shape
        return aff.reshape(b, h // ph, ph, w // pw, pw).mean((2, 4))

    def __call__(self, x, init_actives=None, init_passives=None,
                 make_static=True, **kwargs):
        G = self.G
        x = G._tensor(x)
        if x.dim() == 4:
            x = x[:, None]
        if x.shape[1] == 1:
            x = x.expand(x.shape[0], 2, *x.shape[2:])
        elif make_static:
            # counterfactuals probe motion FROM a static scene: every frame
            # becomes frame 0
            x = x[:, 0:1].expand(x.shape)
        G.set_input(x)
        b = x.shape[0]
        t_grid, gh, gw = G.mask_shape
        n_per = gh * gw

        actives = (G._tensor(init_actives) if init_actives is not None
                   else G.get_zeros_mask())
        passives = (G._tensor(init_passives) if init_passives is not None
                    else G.get_zeros_mask())
        actives = actives.reshape(b, -1)
        passives = passives.reshape(b, -1)
        rows = torch.arange(b, device=G.device)

        all_flows = []
        actives_per_iter = [actives]
        passives_per_iter = [passives]
        filter_masks = []
        for _ in range(self.num_iters):
            _, flows = G.predict_counterfactual_videos_and_flows(
                x, active_patches=actives, passive_patches=passives,
                num_samples=self.samples_per_iter,
                sample_batch_size=self.sample_batch_size, fix_passive=True,
                **kwargs)
            flows_s = G._batch_to_samples(flows)
            if self.do_filter and G.flow_sample_filter is not None:
                a_tiled = actives[..., None].repeat(1, 1, flows_s.shape[-1])
                flows_s, fmask = G.flow_sample_filter(flows_s, a_tiled)
                filter_masks.append(fmask)
            all_flows.append(flows_s)

            aff, _, _ = self.compute_affinity_targets_from_samples(
                torch.cat(all_flows, -1))
            patch_aff = self._patch_pool(aff).reshape(b, n_per)

            # grow: next active = strongest non-active patch; next passive =
            # weakest patch outside both sets (argmax / argmin take the
            # first of tied entries, as jnp's do)
            a_f1 = actives.reshape(b, t_grid, n_per)[:, -1]
            p_f1 = passives.reshape(b, t_grid, n_per)[:, -1]
            taken = (~a_f1) | (~p_f1)
            inf = torch.full_like(patch_aff, float('inf'))
            grow = torch.where(taken, -inf, patch_aff).argmax(-1)
            shrink_scores = torch.where(taken, inf, patch_aff)
            shrink_scores[rows, grow] = float('inf')
            shrink = shrink_scores.argmin(-1)

            a_new = actives.reshape(b, t_grid, n_per).clone()
            p_new = passives.reshape(b, t_grid, n_per).clone()
            a_new[rows, -1, grow] = False
            if self.num_passive > 0:
                p_new[rows, -1, shrink] = False
            actives = a_new.reshape(b, -1)
            passives = p_new.reshape(b, -1)
            actives_per_iter.append(actives)
            passives_per_iter.append(passives)

        self.filter_masks = (torch.cat(filter_masks, -1) if filter_masks
                             else torch.zeros((b, 0), dtype=torch.bool,
                                              device=G.device))
        flow_samples = torch.cat(all_flows, -1)
        return (flow_samples,
                torch.stack(actives_per_iter, -1),
                torch.stack(passives_per_iter, -1))
