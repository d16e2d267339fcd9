"""Port weight bridge: the port's state dicts equal the JAX package's own
torch export key for key and value for value, the port's modules load
them with strict=True, and the seeded initialisers give the same layout."""
import numpy as np
import jax
import pytest
import torch

from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.utils.torch_export import (export_raft,
                                                              export_vmae)
from counterfactualworldmodels_tpu_torch.models import fast_vmae as tfv
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import SMALL_VMAE


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _same(sd, ref):
    assert sorted(sd) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(sd[k]), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize('init_values', [0.0, 0.1])
def test_vmae_state_dict_matches_jax_export(init_values):
    jm = jvmae.PretrainVisionTransformer(**SMALL_VMAE,
                                         init_values=init_values)
    params = _np_tree(jvmae.init_params(jm, jax.random.PRNGKey(1)))
    ref = export_vmae(params, 3, jm.full_patch_size)
    sd = weights.vmae_state_dict_from_jax(params, 3, jm.full_patch_size)
    _same(sd, ref)
    tm = tvmae.PretrainVisionTransformer(**SMALL_VMAE,
                                         init_values=init_values)
    fp = tfv.stack_vmae_params(tm, sd, device='cpu')
    assert fp.enc_blocks['attn']['qkv_kernel'].shape == (3, 64, 192)
    assert ('gamma_1' in fp.dec_blocks) == (init_values > 0)
    # the seeded initialiser emits the same keys and shapes
    init = weights.init_vmae_state_dict(tm, torch.Generator().manual_seed(0))
    assert sorted(init) == sorted(ref)
    for k in ref:
        assert tuple(init[k].shape) == ref[k].shape, k


def test_raft_state_dict_matches_jax_export_and_loads_strict():
    jm = jraft.RAFT(iters=1)
    params = _np_tree(jraft.init_raft_params(jm, jax.random.PRNGKey(2),
                                             hw=32))
    ref = export_raft(params)
    sd = weights.raft_state_dict_from_jax(params)
    _same(sd, ref)
    model = traft.RAFT(iters=1, device='cpu')
    model.load_state_dict(sd, strict=True)
    _same(model.state_dict(), ref)


def test_seeded_initialisers_are_deterministic():
    tm = tvmae.PretrainVisionTransformer(**SMALL_VMAE)
    a = weights.init_vmae_state_dict(tm, torch.Generator().manual_seed(5))
    b = weights.init_vmae_state_dict(tm, torch.Generator().manual_seed(5))
    _same(a, b)
    std = a['encoder.blocks.0.mlp.fc1.weight'].std().item()
    assert abs(std - 64 ** -0.5) < 0.15 * 64 ** -0.5  # lecun_normal scale
    r1 = weights.init_raft(traft.RAFT(device='cpu'),
                           torch.Generator().manual_seed(6))
    r2 = weights.init_raft(traft.RAFT(device='cpu'),
                           torch.Generator().manual_seed(6))
    _same(r1.state_dict(), r2.state_dict())
