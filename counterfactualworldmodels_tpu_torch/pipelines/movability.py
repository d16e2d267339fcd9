"""Iterative movability estimation.

Port of counterfactualworldmodels_tpu/pipelines/movability.py. The outer
iteration (a few steps) stays in Python; each step is one motion map of
``FlowGenerator.sample_counterfactual_motion_map`` (chunks of the
shared-prefix dispatch: K1 for the scene's prefix on an LRU miss, K2 in the
suffix decoder, the RAFT lookup in every refinement iteration). Every draw
goes through the generator's ``_draw_*`` methods, so tests can put the JAX
draws in their place. ``ImuConditionedMovabilityPredictor`` runs the same
loop over the IMU-conditioned pipeline (pipelines/imu.py).
"""
from __future__ import annotations

import time

import torch

from .segmentation import FlowGenerator


class MovabilityPredictor(FlowGenerator):
    """Estimate which parts of a scene are movable by iteratively sampling
    motion counterfactuals from an evolving movability distribution: the
    first map from the keypoint distribution (``keypoint_predictor``), each
    later one from the movability found so far."""

    VERBOSE = False

    def __init__(self, *args,
                 initialize_from_keypoints: bool = True,
                 iterate_from_keypoints: bool = False,
                 keypoints_power: int = 8,
                 movability_power: float = 1,
                 num_initial_samples: int = 16,
                 num_initial_active_patches: int = 1,
                 num_initial_passive_patches: int = 0,
                 num_samples_per_iteration: int = 16,
                 num_active_patches_per_sample: int = 1,
                 num_passive_patches_per_sample: int = 1,
                 sample_passives_from_movable: bool = False,
                 update_distribution_per_iteration: bool = True,
                 num_iters: int = 2,
                 sample_batch_size: int = 4,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.initialize_from_keypoints = initialize_from_keypoints
        self.iterate_from_keypoints = iterate_from_keypoints
        self.keypoints_power = keypoints_power
        self.keypoints_distribution = None
        self.sample_batch_size = sample_batch_size
        self.movability_power = movability_power
        self.sample_passives_from_movable = sample_passives_from_movable
        self.num_initial_samples = num_initial_samples
        self.num_initial_active_patches = num_initial_active_patches
        self.num_initial_passive_patches = num_initial_passive_patches
        self.num_samples_per_iteration = num_samples_per_iteration
        self.num_active_patches_per_sample = num_active_patches_per_sample
        self.num_passive_patches_per_sample = num_passive_patches_per_sample
        self.num_iters = num_iters
        self.update_distribution_per_iteration = \
            update_distribution_per_iteration
        self.reset_samples()

    def set_verbosity(self, is_verbose=True):
        self.VERBOSE = is_verbose

    def set_keypoints_distribution(self, x=None):
        if x is None:
            x = self.x
        if x is None:
            raise ValueError('no input is set (set_input)')
        if self.keypoint_predictor is not None:
            self.keypoints_distribution = self.predict_keypoints_distribution(
                x, power=self.keypoints_power)
        else:
            self.keypoints_distribution = None

    # ------------------------------------------------------------------
    def reset_samples(self):
        self.movability_maps = []
        self.flow_samples_per_iter = []
        self.active_patches_per_iter = []
        self.passive_patches_per_iter = []

    def _update_results(self, results):
        movability, flows, active, passive = results
        self.movability_maps.append(movability)
        self.flow_samples_per_iter.append(flows)
        self.active_patches_per_iter.append(active)
        self.passive_patches_per_iter.append(passive)

    def get_total_movability(self):
        """The mean motion map over every iteration's flow samples."""
        if not self.flow_samples_per_iter:
            return None
        all_flows = torch.cat(self.flow_samples_per_iter, -1)
        return self.compute_mean_motion_map(all_flows,
                                            normalize_per_sample=False,
                                            normalize=True)

    def get_minimum_movability(self):
        """The elementwise minimum of the iterations' mean motion maps."""
        if not self.flow_samples_per_iter:
            return None
        mags = torch.stack([self.compute_mean_motion_map(fs)
                            for fs in self.flow_samples_per_iter], -1)
        return mags.amin(-1)

    # ------------------------------------------------------------------
    # visualization
    # ------------------------------------------------------------------
    def sample_and_visualize_keypoints(self, x=None, sampled_keypoints=None,
                                       sampled_passive_patches=None,
                                       num_samples=32):
        """Overlay the union of sampled active patches in red (and passive
        patches in blue) on the input; samples fresh keypoint patches when
        none are given. Returns (sampled_keypoints, overlay_image)."""
        if x is None:
            if self.x is None:
                raise ValueError('no input is set (set_input)')
            x = self.x
        if sampled_keypoints is None:
            self.set_keypoints_distribution(x)
            sampled_keypoints = self.sample_patches_from_energy(
                energy=self.keypoints_distribution, num_visible=1,
                num_samples=num_samples)
        img = self._tensor(x)

        def overlay(img, patch_masks, channel):
            fill = [0.0, 0.0, 0.0]
            fill[channel] = 1.0
            union = patch_masks.all(-1)      # visible in any sample
            alpha = self.get_masked_pred_patches(
                torch.zeros_like(img), union,
                fill_value=fill)[:, :, channel:channel + 1]
            col = torch.cat([alpha if i == channel else torch.zeros_like(alpha)
                             for i in range(3)], -3)
            return img * (1 - alpha) + 0.5 * alpha * (col + img)

        img = overlay(img, self._tensor(sampled_keypoints), 0)
        if sampled_passive_patches is not None:
            img = overlay(img, self._tensor(sampled_passive_patches), 2)
        return sampled_keypoints, img

    def visualize_iterations(self, axes=None, minimum_movability=False,
                             cmap='inferno'):
        """Grid of (selected patches, movability map) per iteration plus
        the total (matplotlib)."""
        import matplotlib.pyplot as plt
        from ..vis_utils import imshow
        self.fig = None
        num_iters = len(self.movability_maps)
        if num_iters == 0:
            return
        if axes is None:
            self.fig, axes = plt.subplots(
                2, num_iters + 1, figsize=(4 * (num_iters + 1), 8))
        vmax = float(torch.stack(self.movability_maps, -1).max())
        for it in range(num_iters):
            _, img = self.sample_and_visualize_keypoints(
                x=self.x,
                sampled_keypoints=self.active_patches_per_iter[it],
                sampled_passive_patches=self.passive_patches_per_iter[it])
            imshow(img, t=1, ax=axes[0, it])
            imshow(self.movability_maps[it], ax=axes[1, it], cmap=cmap,
                   vmin=0, vmax=vmax)
            axes[0, it].set_title('iteration %d' % it, fontsize=20)
            for row in range(2):
                axes[row, it].set_xticks([])
                axes[row, it].set_yticks([])
        _, img = self.sample_and_visualize_keypoints(
            x=self.x,
            sampled_keypoints=torch.cat(self.active_patches_per_iter, -1),
            sampled_passive_patches=torch.cat(self.passive_patches_per_iter,
                                              -1))
        total = (self.get_minimum_movability() if minimum_movability
                 else self.get_total_movability())
        imshow(img, t=1, ax=axes[0, -1])
        imshow(total, ax=axes[1, -1], cmap=cmap, vmin=0, vmax=vmax)
        axes[0, -1].set_title(
            '%s movability' % ['total', 'minimum'][int(minimum_movability)],
            fontsize=20)
        for row in range(2):
            axes[row, -1].set_xticks([])
            axes[row, -1].set_yticks([])
        axes[0, 0].set_ylabel('selected motion patches', fontsize=18)
        axes[1, 0].set_ylabel('relative movability', fontsize=18)
        plt.tight_layout()
        self.axes = axes

    # ------------------------------------------------------------------
    def _sample_initial_motion_map(self, x, num_samples=None,
                                   sample_batch_size=None, do_filter=True,
                                   normalize=True, patch_sampling_kwargs={},
                                   **kwargs):
        """The first motion map: active patches from the keypoint
        distribution (uniform without one), passive ones from its
        complement."""
        self.set_input(x)
        if self.initialize_from_keypoints:
            self.set_keypoints_distribution()
            sampling_dist = self.keypoints_distribution
            passive_dist = (None if sampling_dist is None
                            else 1 - sampling_dist)
        else:
            sampling_dist = None
            passive_dist = None
        flows, motion_patches, static_patches = \
            self.sample_counterfactual_motion_map(
                x=self.x,
                active_sampling_distribution=sampling_dist,
                passive_sampling_distribution=passive_dist,
                num_active_patches=self.num_initial_active_patches,
                num_passive_patches=self.num_initial_passive_patches,
                num_samples=(num_samples or self.num_initial_samples),
                sample_batch_size=(sample_batch_size or self.sample_batch_size),
                do_filter=do_filter,
                patch_sampling_kwargs=patch_sampling_kwargs,
                **kwargs)
        motion_map = self.compute_mean_motion_map(
            flows, normalize_per_sample=False, normalize=normalize)
        return motion_map, flows, motion_patches, static_patches

    def _iterate_motion_map(self, movability_distribution,
                            sample_passives_from_movable=True,
                            num_active_patches=None, num_passive_patches=None,
                            num_samples=None, sample_batch_size=None,
                            do_filter=True, patch_sampling_kwargs={},
                            normalize=True, **kwargs):
        """A later motion map: active patches from the movability found so
        far (to ``movability_power``), passive ones from its complement (or
        from it, with sample_passives_from_movable)."""
        if self.x is None:
            raise ValueError('no input is set (set_input)')
        if movability_distribution is None:
            movability_distribution = torch.ones_like(self.x[:, 0:1, 0])
        dist = self.compute_mean_motion_map(movability_distribution)
        dist = dist ** self.movability_power
        if sample_passives_from_movable:
            passive_dist = dist
        else:
            passive_dist = torch.clamp(1 - dist, min=0.0)
        if self.iterate_from_keypoints:
            self.set_keypoints_distribution(self.x)
            if self.keypoints_distribution is not None:
                dist = dist * self.keypoints_distribution
                passive_dist = passive_dist * self.keypoints_distribution
        flows, motion_patches, static_patches = \
            self.sample_counterfactual_motion_map(
                x=self.x,
                active_sampling_distribution=dist,
                passive_sampling_distribution=passive_dist,
                num_active_patches=(num_active_patches or
                                    self.num_active_patches_per_sample),
                num_passive_patches=(num_passive_patches or
                                     self.num_passive_patches_per_sample),
                num_samples=(num_samples or self.num_samples_per_iteration),
                sample_batch_size=(sample_batch_size or self.sample_batch_size),
                do_filter=do_filter,
                patch_sampling_kwargs=patch_sampling_kwargs,
                **kwargs)
        motion_map = self.compute_mean_motion_map(
            flows, normalize_per_sample=False, normalize=normalize)
        return motion_map, flows, motion_patches, static_patches

    # ------------------------------------------------------------------
    def __call__(self, x, num_initial_samples=None,
                 num_samples_per_iteration=None, sample_batch_size=None,
                 num_iters=None, **kwargs):
        """The movability loop: one initial motion map, then ``num_iters``
        more. Returns the final movability map [B, 1, H, W]."""
        self.set_input(x)
        self.reset_samples()
        t0 = time.time()

        results = self._sample_initial_motion_map(
            x=self.x, num_samples=num_initial_samples,
            sample_batch_size=sample_batch_size, **kwargs)
        self._update_results(results)
        if self.VERBOSE:
            print('Completed iter 0 with %d samples in %0.3f s'
                  % (results[1].shape[-1], time.time() - t0))
            t0 = time.time()

        for it in range(1, (num_iters or self.num_iters) + 1):
            if self.update_distribution_per_iteration:
                dist = self.get_total_movability()
            else:
                dist = self.movability_maps[-1]
            results = self._iterate_motion_map(
                dist,
                sample_passives_from_movable=self.sample_passives_from_movable,
                num_samples=num_samples_per_iteration,
                sample_batch_size=sample_batch_size, **kwargs)
            self._update_results(results)
            if self.VERBOSE:
                print('Completed iter %d with %d samples in %0.3f s'
                      % (it, results[1].shape[-1], time.time() - t0))
                t0 = time.time()
        return self.movability_maps[-1]

    forward = __call__


def make_imu_conditioned_movability_predictor():
    """The class combining MovabilityPredictor with the IMU-conditioned
    pipeline (ImuConditionedFlowGenerator), as the demo composes them;
    built on call to keep the imports one-way."""
    from .imu import ImuConditionedFlowGenerator

    class ImuConditionedMovabilityPredictor(MovabilityPredictor,
                                            ImuConditionedFlowGenerator):
        pass

    return ImuConditionedMovabilityPredictor


def ImuConditionedMovabilityPredictor(*args, **kwargs):  # noqa: N802
    return make_imu_conditioned_movability_predictor()(*args, **kwargs)
