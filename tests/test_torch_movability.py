"""Port parity: MovabilityPredictor and the keypoint predictor against the
JAX package, on the CPU.

tests/test_segmentation.py's tiny predictor (32 px, 4x4 patches), the large
RAFT with 2 iterations as the flow probe and a large RAFT with
``output_dim=1`` as the keypoint predictor, all with JAX weights bridged by
utils/weights.py. The port's keypoint predictor is the reference's
single-image path: ``apply_raft_video(model, x[:, :1])`` (frame 0 paired
with itself). The JAX generator draws from its key; the port's draw
methods replay it (``JaxDraws``). Each iteration's sampling distribution
comes from the flows of the one before, which agree within 1e-3 px; the
categorical draws read the port's probabilities and match JAX's in these
cases. Masks (active and passive patches per iteration) bitwise; the
keypoint map within 1e-3 and its distribution within 1e-4; flows,
movability maps and the total and minimum movability within 1e-3.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.masking import generators as jgen
from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.pipelines import movability as jmov
from counterfactualworldmodels_tpu_torch.masking import generators as tgen
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.pipelines import movability as tmov
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import TINY, JaxDraws, assert_close, t


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# the JAX initialisers under jit: the same values as eager calls, in a
# third of the time (one compile instead of an op-by-op forward)
_init_vmae = jax.jit(jvmae.init_params, static_argnums=0)
_init_raft = jax.jit(jraft.init_raft_params, static_argnums=(0, 2))


@pytest.fixture(scope='module')
def nets():
    jm = jvmae.PretrainVisionTransformer(**TINY)
    params = _init_vmae(jm, jax.random.PRNGKey(0))
    tm = tvmae.PretrainVisionTransformer(**TINY)
    sd = weights.vmae_state_dict_from_jax(_np_tree(params), 3,
                                          tm.full_patch_size)
    jr = jraft.RAFT(iters=2)
    rparams = _init_raft(jr, jax.random.PRNGKey(1), 32)
    tr = traft.RAFT(iters=2, device='cpu')
    tr.load_state_dict(weights.raft_state_dict_from_jax(_np_tree(rparams)),
                       strict=True)
    jk = jraft.RAFT(iters=2, output_dim=1)
    kparams = _init_raft(jk, jax.random.PRNGKey(2), 32)
    ksd = weights.raft_state_dict_from_jax(_np_tree(kparams))
    tk = traft.RAFT(iters=2, output_dim=1, device='cpu')
    tk.load_state_dict(ksd, strict=True)

    def jkeypoints(p, x):
        return jraft.apply_raft_video(jk, p, x[:, :1], False, 2, True)

    return (dict(predictor=jm, params=params, flow_model=jr,
                 flow_params=rparams, keypoint_predictor=jkeypoints,
                 keypoint_params=kparams),
            dict(predictor=tm, params=sd, flow_model=tr,
                 keypoint_predictor=traft.RaftKeypointPredictor(tk)))


def make_pair(nets, keypoints=True, seed=0, **kw):
    """(JAX MovabilityPredictor, the port's with the JAX draws)."""
    jkw, tkw = (dict(d) for d in nets)
    if not keypoints:
        for d in (jkw, tkw):
            d.pop('keypoint_predictor')
            d.pop('keypoint_params', None)
    kw = dict(dict(raft_iters=2, imagenet_normalize_inputs=True, seed=seed,
                   num_initial_samples=2, num_samples_per_iteration=2,
                   sample_batch_size=2, num_iters=1), **kw)
    jg = jmov.MovabilityPredictor(**jkw, **kw)
    tg = tmov.MovabilityPredictor(**tkw, device='cpu', **kw)
    JaxDraws(tg, seed)
    return jg, tg


def _video(seed):
    return np.random.RandomState(seed).rand(1, 2, 3, 32, 32).astype(
        np.float32)


def test_keypoints_distribution_matches_jax(nets):
    """The large head's map (convex upsampling of a C = 1 map), the
    distribution sigmoid(v)**8 min-max normalised, and the energy pooled
    per patch."""
    jg, tg = make_pair(nets)
    x = _video(1)
    jmap = jg.predict_keypoints_map(jnp.asarray(x))
    tmap = tg.predict_keypoints_map(x)
    assert tuple(tmap.shape) == jmap.shape == (1, 1, 1, 32, 32)
    assert_close(tmap.numpy(), jmap, 1e-3)
    jd = jg.predict_keypoints_distribution(jnp.asarray(x))
    td = tg.predict_keypoints_distribution(x)
    assert tuple(td.shape) == jd.shape == (1, 1, 32, 32)
    assert_close(td.numpy(), jd, 1e-4)
    assert float(td.max()) == pytest.approx(1.0) and float(td.min()) == 0.0
    for mode in ('mean', 'max', 'min'):
        for dens in (np.asarray(jd), x[:, :, :1]):
            ref = jg.patchify_energy_density(jnp.asarray(dens), mode, beta=2.0)
            out = tg.patchify_energy_density(dens, mode, beta=2.0)
            assert tuple(out.shape) == ref.shape
            assert_close(out.numpy(), ref, 1e-6)
    # without a keypoint predictor the map is ones
    jg0, tg0 = make_pair(nets, keypoints=False)
    np.testing.assert_array_equal(tg0.predict_keypoints_map(x).numpy(),
                                  np.asarray(jg0.predict_keypoints_map(
                                      jnp.asarray(x))))


@pytest.mark.parametrize('spread', [1.0, 1e-3, 0.0],
                         ids=['random', 'nearly_flat', 'flat'])
def test_energy_draws_match_jax_on_the_keypoint_scale(spread):
    """energy_frame_mask on an energy map in [0, 1] (as the keypoint
    distribution is), on one that varies by 1e-3 about its level and on a
    flat one: the port's probabilities (patch means, min subtracted, eps
    added, normalised) give JAX's categorical draws, masks bitwise. (Where
    a map varies by less than ~1e-4 of its level, the f32 rounding of the
    patch means, summed in another order, decides near ties and the draws
    can differ.)"""
    rng = np.random.RandomState(2)
    energy = (0.5 + spread * (rng.rand(2, 1, 32, 32) - 0.5)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    ref = jgen.energy_frame_mask(key, jnp.asarray(energy), 8, 8, 3)

    def indices(p, k):
        logits = jnp.log(jnp.clip(jnp.asarray(p.numpy()), min=1e-30))
        return t(jax.random.categorical(key, logits, axis=-1,
                                        shape=(k, p.shape[0])).T).long()

    out = tgen.energy_frame_mask(t(energy), 8, 8, 3, indices=indices)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize('keypoints,do_filter', [
    (True, False), (False, False), (True, True)],
    ids=['keypoints', 'uniform', 'keypoints-filtered'])
def test_movability_predictor_matches_jax(nets, keypoints, do_filter):
    """num_iters=1, S = 2 per iteration: the initial map (from the
    keypoint distribution, or uniform), then one iteration from the total
    movability with one passive patch per sample. Unfiltered, the random
    weights' flows are nonzero, so the second iteration samples from a
    real movability map; with the flow-sample filter (the default) they
    reject every sample."""
    jg, tg = make_pair(nets, keypoints)
    x = _video(5)
    jout = jg(jnp.asarray(x), do_filter=do_filter)
    tout = tg(x, do_filter=do_filter)
    assert tuple(tout.shape) == jout.shape == (1, 1, 32, 32)
    assert len(tg.flow_samples_per_iter) == len(jg.flow_samples_per_iter) == 2
    for it in range(2):
        np.testing.assert_array_equal(
            tg.active_patches_per_iter[it].numpy(),
            np.asarray(jg.active_patches_per_iter[it]))
        np.testing.assert_array_equal(
            tg.passive_patches_per_iter[it].numpy(),
            np.asarray(jg.passive_patches_per_iter[it]))
        assert_close(tg.flow_samples_per_iter[it].numpy(),
                     jg.flow_samples_per_iter[it], 1e-3)
        assert_close(tg.movability_maps[it].numpy(), jg.movability_maps[it],
                     1e-3)
    assert (float(tg.movability_maps[0].max()) > 0.5) == (not do_filter)
    # the second iteration drew one passive patch per sample
    assert int((~tg.passive_patches_per_iter[1][0, 64:]).sum()) == 2
    assert_close(tout.numpy(), jout, 1e-3)
    assert_close(tg.get_total_movability().numpy(),
                 jg.get_total_movability(), 1e-3)
    assert_close(tg.get_minimum_movability().numpy(),
                 jg.get_minimum_movability(), 1e-3)
    if keypoints:
        assert_close(tg.keypoints_distribution.numpy(),
                     jg.keypoints_distribution, 1e-4)
    else:
        assert tg.keypoints_distribution is None
    tg.reset_samples()
    assert tg.get_total_movability() is None
    assert tg.get_minimum_movability() is None


def test_visualization_methods_match_jax(nets):
    """sample_and_visualize_keypoints on given patches (the overlay within
    1e-6 of JAX's) and on fresh ones; visualize_iterations, flowshow and
    maskshow draw under matplotlib's Agg backend."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    jg, tg = make_pair(nets, keypoints=False, seed=1)
    x = _video(6)
    jg(jnp.asarray(x), do_filter=False)
    tg(x, do_filter=False)
    kp, pas = (np.asarray(jg.active_patches_per_iter[1]),
               np.asarray(jg.passive_patches_per_iter[1]))
    _, jimg = jg.sample_and_visualize_keypoints(
        sampled_keypoints=jnp.asarray(kp),
        sampled_passive_patches=jnp.asarray(pas))
    _, timg = tg.sample_and_visualize_keypoints(sampled_keypoints=kp,
                                                sampled_passive_patches=pas)
    assert tuple(timg.shape) == x.shape
    assert_close(timg.numpy(), jimg, 1e-6)
    kps, img = tg.sample_and_visualize_keypoints(num_samples=3)
    assert kps.shape[-1] == 3 and tuple(img.shape) == x.shape
    assert bool(torch.isfinite(img).all()) and bool((~kps.all(-1)).any())
    tg.visualize_iterations()
    assert tg.fig is not None
    # flowshow and maskshow on the same inputs draw the same images
    flow = np.asarray(jg.flow_samples_per_iter[0][..., 0])
    for kw in (dict(), dict(set_max_speed=False)):
        jax_img = jg.flowshow(jnp.asarray(flow), **kw).images[0].get_array()
        img = tg.flowshow(flow, **kw).images[0].get_array()
        assert_close(img, jax_img, 1e-6)
    assert tg._last_max_speed == pytest.approx(jg._last_max_speed)
    np.testing.assert_array_equal(
        tg.maskshow(kp[..., 0]).images[0].get_array(),
        jg.maskshow(jnp.asarray(kp[..., 0])).images[0].get_array())
    plt.close('all')
