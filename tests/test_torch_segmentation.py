"""Port parity: the whole slice, counterfactual_videos_and_flows_fast
(prompt construction -> shared-prefix VMAE -> RAFT with shared frame-0
encoders), against the JAX package at S = 4, 32 px, on both the exact rung
and the pooled rung. Same weights (bridged) and the JAX rectangularizer
draws as the port's noise. Masks match bitwise; videos within 1e-4 (f32
sums in another order); flows within 1e-3 px (two GRU iterations feed
those differences back through the lookup coordinates)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.models import fast_vmae as jfv
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.pipelines import segmentation as jseg
from counterfactualworldmodels_tpu_torch.models import fast_vmae as tfv
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.pipelines import segmentation as tseg
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import (assert_close, jax_uniform_noise, t,
                               vmae_pair)


@pytest.fixture(scope='module')
def setup():
    jm, params, tm, tfp = vmae_pair()
    jfp = jfv.stack_vmae_params(jm, params, dtype=jnp.float32)
    jr = jraft.RAFT(iters=2)
    rparams = jraft.init_raft_params(jr, jax.random.PRNGKey(1), hw=32)
    tr = traft.RAFT(iters=2, device='cpu')
    tr.load_state_dict(weights.raft_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, rparams)), strict=True)

    rng = np.random.RandomState(4)
    s, n, n0 = 4, jm.num_patches, jm.num_patches_per_frame
    x = rng.rand(1, 2, 3, 32, 32).astype(np.float32)
    passive = np.ones((1, n, s), dtype=bool)
    passive[:, :n0] = False
    active = passive.copy()
    for i in range(s):
        passive[0, n0 + rng.choice(n0, 6, replace=False), i] = False
        active[0, n0 + rng.randint(n0), i] = False
    shifts = rng.randint(-3, 4, size=(1, s, 2)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(2), s).reshape(1, s, 2)
    inputs = (x, passive, active, shifts, keys, n0 + 7)
    return (jm, jfp, jr, rparams), (tm, tfp, tr), inputs


@pytest.mark.parametrize('rung', [(1, 1, 'erf'), (4, 4, 'tanh')],
                         ids=['exact', 'pool4'])
def test_counterfactual_videos_and_flows_fast_matches_jax(setup, rung):
    (jm, jfp, jr, rparams), (tm, tfp, tr), inputs = setup
    x, passive, active, shifts, keys, n_vis = inputs
    pp, sp, gelu = rung
    n0 = jm.num_patches_per_frame
    n1 = jm.num_patches - n0
    pad = jfv.sfx_bucket(n_vis - n0, n1)
    jy, jf, jmask = jseg.counterfactual_videos_and_flows_fast(
        jm, jfp, jr, rparams, jnp.asarray(x), jnp.asarray(passive),
        jnp.asarray(active), jnp.asarray(shifts), keys, pad, True, 2, True,
        False, False, None, pp, sp, gelu, n_vis=n_vis)
    noise = t(jax_uniform_noise(keys[0], n1))
    ty, tf, tmask = tseg.counterfactual_videos_and_flows_fast(
        tm, tfp, tr, t(x), t(passive), t(active), t(shifts), noise,
        tfv.sfx_bucket(n_vis - n0, n1), True, 2, True, None, pp, sp, gelu,
        n_vis=n_vis)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert ty.shape == jy.shape and tf.shape == jf.shape
    assert_close(ty.numpy(), jy, 1e-4)
    assert_close(tf.numpy(), jf, 1e-3)


def test_counterfactual_fast_argument_checks(setup):
    (jm, _, _, _), (tm, tfp, tr), inputs = setup
    x, passive, active, shifts, _, n_vis = inputs
    args = (tm, tfp, tr, t(x), t(passive), t(active), t(shifts), None, 8,
            True, 1, True)
    with pytest.raises(TypeError, match='n_vis is required'):
        tseg.counterfactual_videos_and_flows_fast(*args)
    x2 = torch.cat([t(x), t(x)])
    with pytest.raises(ValueError, match='B == 1'):
        tseg.counterfactual_videos_and_flows_fast(
            tm, tfp, tr, x2, *args[4:], n_vis=n_vis)
