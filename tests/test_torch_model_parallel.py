"""Port parity: model sharding (parallel/mesh.py's partition rules,
parallel/tensor.py, sequence.py and pipeline.py, the dp x tp train steps,
the trainers' --tp and the checkpoint's gather) on gloo ranks on the CPU.

Single-process: the port's rules against JAX's partition_spec_for on every
parameter of the tiny VMAE, ChannelMAE and conjoined models, matched
through the weight bridge's names; the per-third split of the fused qkv
against JAX's shard of its [D, 3, A] kernel; the per-module replication
with JAX's warning; the head-misalignment ValueError; the forward-only
stacks' refusal under autograd.

One spawn of four ranks (tests/torch_model_parallel_ranks.py, which imports
no JAX; a FileStore under the test's tmp dir) runs the rest while the
parent computes the references:
- the dp 2 x tp 2 steps of the three families (tests/test_parallel.py's
  tiny configurations and optimizer), three steps each, against JAX's
  make_sharded_*_train_step on four host devices and the port's
  single-process step: loss rtol 1e-4 and grad_norm rtol 1e-5 at every
  step; the gathered parameters atol 1e-5 after the first step, as
  tests/test_parallel.py compares them, and atol 1e-4 after the third
  (test_torch_parallel's bar for three dp steps: after a real AdamW update
  JAX's own single-device step and the port's differ from JAX's sharded
  one by up to 4e-5 in a few entries whose gradient is near zero, where
  Adam's normalised step magnifies rounding); every rank's parameters
  bitwise equal;
- the tp 4, sp 4 and pp 4 encoder stacks (pp at 2 and 4 microbatches; tp
  and sp also with layerscale gammas and a custom qk_scale) against JAX's
  make_{tp,sp,pp}_encoder_forward and the sequential stack, atol 1e-5;
- a block's gradients at tp 4 against the single-process ones: equal with
  Megatron's two Functions; with a plain identity in copy_to_tp's place
  (the forward all-reduce alone) the replicated LayerNorm's differ;
- ranks 0 and 1 then form a group of two for ``train_vmae --tp 2``: two
  steps with a checkpoint, resumed at tp 1 here, and a tp 1 checkpoint
  resumed at tp 2 there; the resumed step's loss equals the uninterrupted
  tp 1 run's within 1e-5.
"""
import math
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu import parallel as jpar
from counterfactualworldmodels_tpu.models import cmae as jcmae
from counterfactualworldmodels_tpu.models import conjoined as jconj
from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu.models.layers import Block as JBlock
from counterfactualworldmodels_tpu.parallel import mesh as jmesh
from counterfactualworldmodels_tpu.training import train as JT
from counterfactualworldmodels_tpu.utils import torch_convert as jconvert
from counterfactualworldmodels_tpu_torch import parallel
from counterfactualworldmodels_tpu_torch.models import cmae as tcmae
from counterfactualworldmodels_tpu_torch.models import conjoined as tconj
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.parallel import mesh as pmesh
from counterfactualworldmodels_tpu_torch.training import train_vmae
from counterfactualworldmodels_tpu_torch.utils import weights

import torch_model_parallel_ranks as R
from test_torch_multihost import spawn_ranks, two_threads  # noqa: F401
from torch_port_common import assert_close

FAMILIES = ('vmae', 'cmae', 'conj')


class _Mesh:
    """A mesh's names and sizes, for the rules' checks that run before any
    collective (one process cannot hold a tp group of two)."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())

    def size(self, dim):
        return self._sizes[dim]

    def get_coordinate(self):
        return [0] * len(self._sizes)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _port_models():
    """The three families' port models (seeded) with their JAX models and
    the JAX trees, carried over by the JAX package's own converters."""
    vcfg = tvmae.PretrainVisionTransformer(**R.VMAE)
    cm = tcmae.ChannelMae(**R.CMAE, attn_impl='dense', device='cpu')
    conj = tconj.ConjoinedVMAE(main=tconj.StreamSpec(**R.CONJ_MAIN),
                               context=tconj.StreamSpec(**R.CONJ_CTX),
                               device='cpu', **R.CONJ_PAIRS)
    sd = dict(vmae=weights.init_vmae_state_dict(vcfg, _gen(0)),
              cmae=weights.init_channel_mae_state_dict(cm, _gen(1)),
              conj=weights.init_conjoined_state_dict(conj, _gen(2)))
    jm = dict(vmae=jvmae.PretrainVisionTransformer(**R.VMAE),
              cmae=jcmae.ChannelMae(**R.CMAE),
              conj=jconj.ConjoinedVMAE(
                  main=jconj.StreamSpec(**R.CONJ_MAIN),
                  context=jconj.StreamSpec(**R.CONJ_CTX), **R.CONJ_PAIRS))
    trees = dict(vmae=jconvert.convert_vmae(sd['vmae']),
                 cmae=jconvert.convert_channel_mae(sd['cmae']),
                 conj=jconvert.convert_conjoined(sd['conj']))
    return sd, jm, trees, dict(vmae=vcfg, cmae=cm, conj=conj)


def _bridge(name, tree, port):
    """The port's state dict of a JAX tree of family ``name``."""
    tree = jax.tree_util.tree_map(np.asarray, tree)
    if name == 'vmae':
        return weights.vmae_state_dict_from_jax(tree, 3,
                                                port.full_patch_size)
    if name == 'cmae':
        return weights.channel_mae_state_dict_from_jax(
            tree, R.CMAE['channel_partition'], R.CMAE['patch_size'])
    return weights.conjoined_state_dict_from_jax(port, tree)


def _paths(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        out.update(_paths(v, path) if isinstance(v, dict) else {path: v})
    return out


def _expected(spec, ndim):
    """JAX's PartitionSpec of a leaf as the port's Split of the bridged
    tensor: a [D, 3, A] qkv kernel becomes the per-third split of
    [3A, D]; a 2-D [in, out] kernel the transposed dim; a vector its own."""
    dims = [i for i, a in enumerate(spec) if a == 'tp']
    if not dims:
        return None
    if ndim == 3:
        return pmesh.Split(0, thirds=True)
    return pmesh.Split(1 - dims[0] if ndim == 2 else dims[0])


# ---------------------------------------------------------------------------
# single-process rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', FAMILIES)
def test_partition_rules_match_jax(name):
    """Every leaf of the JAX tree is marked with its index, bridged to the
    port's names, and the port's rule for that name must be JAX's rule for
    the leaf's path, on the port's layout."""
    _, _, trees, ports = _port_models()
    paths = _paths(trees[name])
    marked = {}
    for i, (path, leaf) in enumerate(paths.items()):
        node = marked
        *parents, key = path.split('/')
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = np.full(np.shape(leaf), i, np.float32)
    sd = _bridge(name, marked, ports[name])
    order = list(paths)
    rules = dict(conj=(pmesh.CONJOINED_PARTITION_RULES,
                       jmesh.CONJOINED_PARTITION_RULES)).get(
        name, (pmesh.VMAE_PARTITION_RULES, jmesh.VMAE_PARTITION_RULES))
    n_split = 0
    for key, v in sd.items():
        idx = set(np.unique(v.numpy()).tolist())
        assert len(idx) == 1, key
        path = order[int(idx.pop())]
        want = _expected(jmesh.partition_spec_for(path, rules[1]),
                         np.ndim(paths[path]))
        assert pmesh.partition_spec_for(key, rules[0]) == want, (key, path)
        n_split += want is not None
    assert set(sd) == set(dict(ports[name].state_dict()) if name != 'vmae'
                          else tvmae.PretrainVisionTransformerModule(
                              ports[name], device='cpu').state_dict())
    assert n_split >= 6


def test_qkv_splits_per_third_as_jax_shards():
    """Rank r's rows of the fused qkv [3A, D] are JAX's shard r of the
    [D, 3, A] kernel (A split over tp): q, k and v each keep their
    heads; the full weight comes back from the blocks."""
    rng = np.random.RandomState(0)
    d, a, tp = 8, 12, 2
    kernel = rng.randn(d, 3, a).astype(np.float32)
    full = torch.from_numpy(kernel.reshape(d, 3 * a).T.copy())
    split = pmesh.Split(0, thirds=True)
    blocks = []
    for r in range(tp):
        shard = kernel[:, :, r * a // tp:(r + 1) * a // tp]
        local = split.local(full, tp, r)
        np.testing.assert_array_equal(local.numpy(),
                                      shard.reshape(d, -1).T)
        blocks.append(local)
    assert torch.equal(split.full(blocks), full)
    # a contiguous row split would give rank 0 all of q and half of k
    assert not torch.equal(pmesh.Split(0).local(full, tp, 0), blocks[0])


def test_indivisible_modules_replicate_with_jax_warning():
    """tp 4 on the tiny VMAE: the decoder's 2 heads do not split, so its
    attention stays replicated (JAX's warning); its MLP (128 hidden)
    splits. tp 3 replicates everything, each module with a warning. A
    mesh without 'tp' replicates silently."""
    cfg = tvmae.PretrainVisionTransformer(**R.VMAE)
    model = tvmae.PretrainVisionTransformerModule(cfg, device='cpu')
    with pytest.warns(UserWarning, match='replicating decoder.blocks.0.attn'):
        specs = pmesh.param_shardings(model, _Mesh(dp=1, tp=4))
    assert specs['decoder.blocks.0.attn.qkv.weight'] is None
    assert specs['decoder.blocks.0.attn.proj.weight'] is None
    assert specs['decoder.blocks.0.mlp.fc1.weight'] == pmesh.Split(0)
    assert specs['encoder.blocks.1.attn.qkv.weight'] == pmesh.Split(0, True)
    assert specs['encoder.blocks.1.attn.proj.bias'] is None
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        specs = pmesh.param_shardings(model, _Mesh(tp=3))
    assert all(s is None for s in specs.values())
    assert len(seen) == 2 * (cfg.encoder_depth + cfg.decoder_depth)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        specs = pmesh.param_shardings(model, _Mesh(dp=2))
    assert all(s is None for s in specs.values())


def test_head_misalignment_and_autograd_raise():
    """Head counts that do not divide tp are an error on the explicit
    stack (JAX's tensor_parallel_blocks); the forward-only sp and pp
    stacks refuse inputs that require grad."""
    cfg = tvmae.PretrainVisionTransformer(**R.STACKS['tp'][0])
    x = torch.zeros(2, 16, 64)
    with pytest.raises(ValueError, match='num_heads=6 not divisible'):
        parallel.tensor_parallel_blocks({}, x, _Mesh(tp=4), num_heads=6)
    with pytest.raises(ValueError, match='not divisible'):
        parallel.make_tp_encoder_forward(
            tvmae.PretrainVisionTransformer(**dict(
                R.STACKS['tp'][0], encoder_num_heads=2)), _Mesh(tp=4))
    assert cfg.encoder_num_heads == 4
    xg = x.requires_grad_()
    with pytest.raises(RuntimeError, match='is a forward'):
        parallel.pipelined_blocks({}, xg, None, None, 1)
    with pytest.raises(RuntimeError, match='is a forward'):
        parallel.sequence_parallel_blocks({}, xg, None, 4)


def test_stack_and_unstack_round_trip():
    cfg = tvmae.PretrainVisionTransformer(**R.STACKS['pp'][0])
    enc = R.encoder_sd(weights.init_vmae_state_dict(cfg, _gen(3)))
    stacked = parallel.stack_block_params(enc, cfg.encoder_depth)
    assert stacked['attn.qkv.weight'].shape == (8, 144, 48)
    back = parallel.unstack_block_params(stacked, cfg.encoder_depth)
    assert set(back) == {k for k in enc if k.startswith('blocks.')}
    for k, v in back.items():
        assert torch.equal(v, enc[k]), k


# ---------------------------------------------------------------------------
# the spawn
# ---------------------------------------------------------------------------

def _jax_families(sd, jm, trees, inputs):
    """JAX's make_sharded_*_train_step on a dp 2 x tp 2 mesh of host
    devices, two steps each; the parameters bridged to the port's names."""
    mesh = jpar.make_mesh({'dp': 2, 'tp': 2})
    jopt = JT.make_optimizer(**R.OPT)
    out = {}
    for name in FAMILIES:
        params = jax.tree_util.tree_map(jnp.asarray, trees[name])
        state = JT.TrainState(jnp.zeros((), jnp.int32), params,
                              jopt.init(params))
        n_vis = inputs['n_vis'][name]
        if name == 'vmae':
            made = JT.make_sharded_train_step(jm[name], jopt, mesh, n_vis,
                                              remat=False)
        elif name == 'cmae':
            made = JT.make_sharded_cmae_train_step(
                jm[name], jopt, mesh, n_vis, inputs['counts'], remat=False)
        else:
            made = JT.make_sharded_conjoined_train_step(
                jm[name], jopt, mesh, *n_vis, remat=False)
        step, shard_state, sh = made
        state = shard_state(state)
        batch = [jax.device_put(a, sh) for a in inputs['batch'][name]]
        metrics, params = [], []
        for i in range(R.STEPS):
            state, met = step(state, *batch)
            metrics.append({k: float(v) for k, v in met.items()})
            if i in (0, R.STEPS - 1):
                # the step donates its state: copy the parameters out
                params.append(jax.tree_util.tree_map(np.array, state.params))
        out[name] = (metrics, params)
    return out


def _jax_stacks(sd, inputs):
    """JAX's make_{tp,sp,pp}_encoder_forward on four host devices."""
    out = {}
    for key, name, how, kw in (('tp', 'tp', 'tp', {}), ('sp', 'sp', 'sp', {}),
                               ('pp2', 'pp', 'pp', dict(num_microbatches=2)),
                               ('pp4', 'pp', 'pp', dict(num_microbatches=4)),
                               ('layerscale_tp', 'layerscale', 'tp', {}),
                               ('layerscale_sp', 'layerscale', 'sp', {})):
        model = jvmae.PretrainVisionTransformer(**R.STACKS[name][0])
        enc = jax.tree_util.tree_map(
            jnp.asarray, jconvert.convert_vmae(sd[name])['encoder'])
        make = {'tp': jpar.make_tp_encoder_forward,
                'sp': jpar.make_sp_encoder_forward,
                'pp': jpar.make_pp_encoder_forward}[how]
        fwd, shard = make(model, jpar.make_mesh({how: R.WORLD}), **kw)
        out[key] = np.asarray(fwd(shard(enc),
                                  jnp.asarray(inputs['tokens'][name])))
    # the flax Block applied layer by layer, once per configuration
    for name in ('tp', 'sp', 'pp', 'layerscale'):
        model = jvmae.PretrainVisionTransformer(**R.STACKS[name][0])
        enc = jconvert.convert_vmae(sd[name])['encoder']
        block = JBlock(dim=model.encoder_embed_dim,
                       num_heads=model.encoder_num_heads,
                       mlp_ratio=model.mlp_ratio, qkv_bias=model.qkv_bias,
                       qk_scale=model.qk_scale,
                       init_values=model.init_values)
        apply = jax.jit(lambda p, x: block.apply({'params': p}, x))
        x = jnp.asarray(inputs['tokens'][name])
        for i in range(model.encoder_depth):
            x = apply(enc[f'blocks_{i}'], x)
        out['flax_' + name] = np.asarray(x)
    return out


def _trainer(argv, ckpt=None):
    if ckpt:
        argv = argv + ['--checkpoint-dir', ckpt]
    return train_vmae.main(R.TRAINER + argv)


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """The ranks' results; the port's single-process references and
    JAX's, computed while the ranks run."""
    tmp = str(tmp_path_factory.mktemp('ranks'))
    sd, jm, trees, _ = _port_models()
    rng = np.random.RandomState(0)
    inputs = R.make_inputs(rng)
    inputs['sd'] = sd
    inputs['stack_sd'] = {
        name: weights.init_vmae_state_dict(
            tvmae.PretrainVisionTransformer(**cfg), _gen(10 + i))
        for i, (name, (cfg, _)) in enumerate(R.STACKS.items())}
    # the tp 1 runs: three steps uninterrupted, and two with a checkpoint
    # that the ranks resume at tp 2
    refs = {'tp1_full': _trainer(['--steps', '3'])}
    _trainer(['--steps', '2'], os.path.join(tmp, 'ck_tp1'))
    torch.save(inputs, os.path.join(tmp, 'inputs.pt'))
    join = spawn_ranks(tmp, R.rank_main, world=R.WORLD)
    try:
        refs['families'] = {name: R.run_family(name, inputs)
                            for name in FAMILIES}
        refs['sequential'] = {name: R.sequential_stack(name, inputs)
                              for name in R.STACKS}
        refs['grads'] = R.block_grads()
        jax_out = _jax_families(sd, jm, trees, inputs)
        jax_stacks = _jax_stacks(inputs['stack_sd'], inputs)
    finally:
        ranks = join()
    # the tp 2 run's checkpoint at step 2, resumed at tp 1 here
    refs['tp1_from_tp2'] = _trainer(['--steps', '3'],
                                    os.path.join(tmp, 'ck_tp2'))
    jax_sd = {name: [_bridge(name, tree, p) for tree in jax_out[name][1]]
              for name, p in _port_models()[3].items()}
    return ranks, refs, jax_out, jax_sd, jax_stacks


def _steps_close(got, ref):
    assert len(got) == len(ref) == R.STEPS
    for a, b in zip(got, ref):
        assert math.isclose(a['loss'], b['loss'], rel_tol=1e-4), (a, b)
        assert math.isclose(a['grad_norm'], b['grad_norm'],
                            rel_tol=1e-5), (a, b)


@pytest.mark.parametrize('family', FAMILIES)
def test_dp_tp_step_matches_jax_sharded_step(run, family):
    ranks, refs, jax_out, jax_sd, _ = run
    metrics, params, shards = ranks[0]['families'][family]
    # against JAX's sharded step, and the port's own single-process step
    for ref_metrics, ref_params in (jax_out[family][0], jax_sd[family]), \
            refs['families'][family][:2]:
        _steps_close(metrics, ref_metrics)
        for got, ref, atol in zip(params, ref_params, (1e-5, 1e-4)):
            assert set(got) == set(ref)
            for k, v in ref.items():
                assert_close(got[k].numpy(), v.numpy(), atol=atol)
    # the split parameters really are split, and every rank ends equal
    full = params[-1]
    assert shards and all(shards[n] != tuple(full[n].shape) for n in shards)
    if family == 'conj':
        assert shards['encoder_conjoining_blocks.0-0.cross_attention.v.'
                      'weight'] == (24, 48)
    if family == 'cmae':
        assert shards['encoder.blocks.0.attn.qkv.weight'] == (96, 64)
    for rk in ranks[1:]:
        assert rk['families'][family][0] == metrics
        for k, v in full.items():
            assert torch.equal(rk['families'][family][1][-1][k], v), k


@pytest.mark.parametrize('key', ['tp', 'sp', 'pp2', 'pp4', 'layerscale_tp',
                                 'layerscale_sp'])
def test_encoder_stacks_match_jax(run, key):
    ranks, refs, _, _, jax_stacks = run
    name = key.split('_')[0] if key.startswith('layerscale') else key[:2]
    for rk in ranks:
        got = rk['stacks'][key]
        assert_close(got, jax_stacks[key], atol=1e-5)
        assert_close(got, refs['sequential'][name], atol=1e-5)
    assert_close(jax_stacks['flax_' + name], refs['sequential'][name],
                 atol=1e-5)


def test_replicated_parameters_get_the_full_gradient(run):
    """With copy_to_tp's backward all-reduce every gradient (gathered) is
    the single-process one; without it (the forward all-reduce alone) the
    replicated norm1 weight gets only part of its gradient."""
    ranks, refs, _, _, _ = run
    ref = refs['grads']
    for rk in ranks:
        for k, v in rk['grads']['tp'].items():
            assert_close(v.numpy(), ref[k].numpy(), atol=1e-6, rtol=1e-5)
        wrong = rk['grads']['forward_only']
        for norm in ('norm1.weight', 'norm2.weight'):
            err = float((wrong[norm] - ref[norm]).abs().max())
            assert err > 1e-2 * float(ref[norm].abs().max()), (norm, err)
        # the row-parallel bias after the MLP's reduction is unaffected
        assert_close(wrong['mlp.fc2.bias'].numpy(),
                     ref['mlp.fc2.bias'].numpy(), atol=1e-6, rtol=1e-5)


def test_checkpoint_resumes_across_tp_sizes(run):
    """train_vmae --tp 2 on two ranks: its step-2 checkpoint (gathered to
    full size) resumed at tp 1, and the tp 1 checkpoint resumed at tp 2,
    both give the uninterrupted tp 1 run's third loss within 1e-5."""
    ranks, refs, _, _, _ = run
    full = refs['tp1_full']
    assert [r['step'] for r in full] == [1, 2, 3]
    for rk in ranks[:2]:
        tp2 = rk['trainer']['tp2']
        assert [r['step'] for r in tp2] == [1, 2]
        for a, b in zip(tp2, full):
            assert math.isclose(a['loss'], b['loss'], rel_tol=1e-5)
        resumed = rk['trainer']['tp2_from_tp1']
        assert [r['step'] for r in resumed] == [3]
        assert math.isclose(resumed[0]['loss'], full[2]['loss'],
                            rel_tol=1e-5)
    assert all('trainer' not in rk for rk in ranks[2:])
    back = refs['tp1_from_tp2']
    assert [r['step'] for r in back] == [3]
    assert math.isclose(back[0]['loss'], full[2]['loss'], rel_tol=1e-5)
