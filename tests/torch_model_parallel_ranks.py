"""The rank side of tests/test_torch_model_parallel.py: the port's model
sharding on gloo ranks on the CPU. It imports no JAX, so the spawned ranks
start quickly; the parent imports it too, for the single-process
references and the shared configurations.
"""
import copy
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from counterfactualworldmodels_tpu_torch import parallel
from counterfactualworldmodels_tpu_torch.models import cmae as tcmae
from counterfactualworldmodels_tpu_torch.models import conjoined as tconj
from counterfactualworldmodels_tpu_torch.models import layers as tlayers
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.parallel import tensor as ptensor
from counterfactualworldmodels_tpu_torch.training import train as TT
from counterfactualworldmodels_tpu_torch.training import train_vmae

WORLD = 4
JOIN_S = 300
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
STEPS = 3

# tests/test_parallel.py's tiny configurations: the dp x tp steps (:119,
# :151, :210) and the tp / sp / pp stacks (:271, :317, :400, :633)
VMAE = dict(img_size=(32, 32), patch_size=(8, 8), encoder_embed_dim=64,
            encoder_depth=2, encoder_num_heads=4, decoder_embed_dim=32,
            decoder_depth=1, decoder_num_heads=2, num_frames=2)
CMAE = dict(image_size=(32, 32), patch_size=(16, 16), in_channels=3,
            channel_partition=(3,), encoder_embed_dim=64, encoder_depth=2,
            encoder_num_heads=4, decoder_embed_dim=48, decoder_depth=1,
            decoder_num_heads=4, mlp_ratio=2.0)
CONJ_MAIN = dict(img_size=(32, 32), patch_size=(8, 8), in_chans=3,
                 num_frames=2, encoder_embed_dim=48, encoder_depth=2,
                 encoder_num_heads=4, decoder_embed_dim=32, decoder_depth=1,
                 decoder_num_heads=4, mlp_ratio=2.0)
CONJ_CTX = dict(is_imu=True, in_chans=6, sequence_length=32, imu_tubelet=8,
                encoder_embed_dim=32, encoder_depth=2, encoder_num_heads=4,
                decoder_embed_dim=24, decoder_depth=1, decoder_num_heads=4,
                decoder_num_classes=48, mlp_ratio=2.0,
                concat_dummy_token=True)
CONJ_PAIRS = dict(conjoin_encoder_layers=((0, 0), (1, 1)),
                  conjoin_decoder_layers=((0, 0),))
STACKS = {  # name: (configuration, tokens [B, N])
    'tp': (dict(VMAE, encoder_embed_dim=64, encoder_depth=3, mlp_ratio=2.0,
                qkv_bias=True, tubelet_size=1), (2, 16)),
    'sp': (dict(VMAE, encoder_embed_dim=48, encoder_depth=3, mlp_ratio=2.0,
                qkv_bias=True, tubelet_size=1), (2, 16)),
    'pp': (dict(VMAE, encoder_embed_dim=48, encoder_depth=8, mlp_ratio=2.0,
                qkv_bias=True, tubelet_size=1), (4, 17)),
    'layerscale': (dict(VMAE, init_values=0.1, qk_scale=0.17), (2, 32)),
}
# a warm-up longer than the runs: each step's learning rate is then the
# same whatever --steps says, so a run cut at step 2 and resumed repeats
# the uninterrupted run
TRAINER = ['--synthetic', '--model', 'tiny', '--img-size', '16',
           '--patch-size', '8', '--batch-size', '2', '--warmup-steps', '4',
           '--lr', '1e-3', '--device', 'cpu']


# ---------------------------------------------------------------------------
# the three families' steps, single-process or sharded over a mesh
# ---------------------------------------------------------------------------

def family_model(name, sd):
    """(the port's model of family ``name`` with state dict sd, its
    configuration for the step)."""
    if name == 'vmae':
        cfg = tvmae.PretrainVisionTransformer(**VMAE)
        m = tvmae.PretrainVisionTransformerModule(cfg, device='cpu')
    elif name == 'cmae':
        m = tcmae.ChannelMae(**CMAE, attn_impl='dense', device='cpu')
        cfg = m
    else:
        m = tconj.ConjoinedVMAE(main=tconj.StreamSpec(**CONJ_MAIN),
                                context=tconj.StreamSpec(**CONJ_CTX),
                                device='cpu', **CONJ_PAIRS)
        cfg = m
    m.load_state_dict(sd, strict=True)
    return cfg, m


def run_family(name, inputs, mesh=None):
    """STEPS steps of family ``name`` on the global batch of ``inputs``
    (the dp x tp step on this rank's rows with a mesh, else the
    single-process step). Returns (per-step metrics, the full state dicts
    after the first step and after the last, every split parameter's
    shard shape)."""
    cfg, m = family_model(name, inputs['sd'][name])
    opt = TT.make_optimizer(**OPT)
    state = TT.TrainState(0, m, opt.init(m.parameters()))
    args = [torch.from_numpy(a) for a in inputs['batch'][name]]
    if name == 'vmae':
        make, sharded = ((TT.make_train_step, dict(device='cpu')),
                         (TT.make_sharded_train_step, dict(device='cpu')))
        extra = (inputs['n_vis'][name],)
    elif name == 'cmae':
        make, sharded = ((TT.make_cmae_train_step, {}),
                         (TT.make_sharded_cmae_train_step, {}))
        extra = (inputs['n_vis'][name], inputs['counts'])
    else:
        make, sharded = ((TT.make_conjoined_train_step, {}),
                         (TT.make_sharded_conjoined_train_step, {}))
        extra = inputs['n_vis'][name]
    if mesh is None:
        step = make[0](cfg, opt, *extra, remat=False, **make[1])
    else:
        step, shard_state, dp = sharded[0](cfg, opt, mesh, *extra,
                                           remat=False, **sharded[1])
        state = shard_state(state)
        args = [dp.local(a) for a in args]
    metrics, params = [], []
    for i in range(STEPS):
        state, met = step(state, *args)
        metrics.append({k: float(v) for k, v in met.items()})
        if i in (0, STEPS - 1):
            params.append({k: v.detach().clone()
                           for k, v in ptensor.full_state_dict(m).items()})
    shards = {n: tuple(p.shape) for n, p in m.named_parameters()
              if getattr(p, 'tp_split', None) is not None}
    return metrics, params, shards


# ---------------------------------------------------------------------------
# the encoder stacks
# ---------------------------------------------------------------------------

def encoder_sd(sd):
    return {k[len('encoder.'):]: v for k, v in sd.items()
            if k.startswith('encoder.')}


def sequential_stack(name, inputs):
    """The stack's blocks one after another on one process (the plain
    path of models/layers.Block)."""
    cfg = tvmae.PretrainVisionTransformer(**STACKS[name][0])
    sd = encoder_sd(inputs['stack_sd'][name])
    x = torch.from_numpy(inputs['tokens'][name])
    block = tlayers.Block(cfg.encoder_embed_dim, cfg.encoder_num_heads,
                          cfg.mlp_ratio, cfg.qkv_bias, cfg.qk_scale,
                          cfg.init_values, device='cpu')
    with torch.no_grad():
        for i in range(cfg.encoder_depth):
            block.load_state_dict({k[len(f'blocks.{i}.'):]: v for k, v in
                                   sd.items()
                                   if k.startswith(f'blocks.{i}.')})
            x = block(x)
    return x.numpy()


def parallel_stack(name, how, inputs, mesh, **kw):
    cfg = tvmae.PretrainVisionTransformer(**STACKS[name][0])
    make = {'tp': parallel.make_tp_encoder_forward,
            'sp': parallel.make_sp_encoder_forward,
            'pp': parallel.make_pp_encoder_forward}[how]
    fwd, shard = make(cfg, mesh, **kw)
    with torch.no_grad():
        return fwd(shard(encoder_sd(inputs['stack_sd'][name])),
                   torch.from_numpy(inputs['tokens'][name])).numpy()


# ---------------------------------------------------------------------------
# the replicated parameters' gradients
# ---------------------------------------------------------------------------

def block_grads(mesh=None, copy_backward=True):
    """The gradients of one block (D 64, 4 heads) under a square loss on
    seeded inputs: single-process without a mesh; tensor-parallel over
    the mesh's 'tp' otherwise, gathered to full size, with Megatron's
    copy_to_tp or (copy_backward=False) with a plain identity in its
    place, which leaves the forward's all-reduce and drops the backward's."""
    g = torch.Generator().manual_seed(5)
    block = tlayers.Block(64, 4, 2.0, True, device='cpu')
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2 + (
                1.0 if p.dim() == 1 and p.shape[0] == 64 else 0.0))
    x = torch.randn(2, 16, 64, generator=g)
    if mesh is not None:
        block = parallel.shard_params(copy.deepcopy(block), mesh)
    saved = ptensor.copy_to_tp
    if not copy_backward:
        ptensor.copy_to_tp = lambda t, group: t
    try:
        (block(x) ** 2).mean().backward()
    finally:
        ptensor.copy_to_tp = saved
    plan = getattr(block, 'tp_plan', None)
    return {n: (ptensor.gather_split(p.grad, p.tp_split, plan)
                if getattr(p, 'tp_split', None) is not None
                else p.grad).clone() for n, p in block.named_parameters()}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _join_group(rank, tmp, store, world):
    parallel.initialize_distributed(
        init_method='file://' + os.path.join(tmp, store), world_size=world,
        rank=rank, device='cpu', timeout_s=JOIN_S)


def _checks(rank, tmp):
    inputs = torch.load(os.path.join(tmp, 'inputs.pt'), weights_only=False)
    out = {}
    mesh = parallel.make_mesh({'dp': 2, 'tp': 2})
    out['families'] = {name: run_family(name, inputs, mesh)
                       for name in ('vmae', 'cmae', 'conj')}
    meshes = {how: parallel.make_mesh({how: WORLD})
              for how in ('tp', 'sp', 'pp')}
    out['stacks'] = {
        'tp': parallel_stack('tp', 'tp', inputs, meshes['tp']),
        'sp': parallel_stack('sp', 'sp', inputs, meshes['sp']),
        'pp2': parallel_stack('pp', 'pp', inputs, meshes['pp'],
                              num_microbatches=2),
        'pp4': parallel_stack('pp', 'pp', inputs, meshes['pp'],
                              num_microbatches=4),
        'layerscale_tp': parallel_stack('layerscale', 'tp', inputs,
                                        meshes['tp']),
        'layerscale_sp': parallel_stack('layerscale', 'sp', inputs,
                                        meshes['sp'])}
    out['grads'] = dict(tp=block_grads(meshes['tp']),
                        forward_only=block_grads(meshes['tp'], False))
    dist.destroy_process_group()
    # ranks 0 and 1: train_vmae --tp 2 (dp 1) on a group of two
    if rank < 2:
        _join_group(rank, tmp, 'store2', 2)
        out['trainer'] = dict(
            tp2=train_vmae.main(TRAINER + [
                '--tp', '2', '--steps', '2', '--checkpoint-dir',
                os.path.join(tmp, 'ck_tp2')]),
            tp2_from_tp1=train_vmae.main(TRAINER + [
                '--tp', '2', '--steps', '3', '--checkpoint-dir',
                os.path.join(tmp, 'ck_tp1')]))
        dist.destroy_process_group()
    return out


def rank_main(rank, tmp):
    """One spawned rank: the gloo group of four (a FileStore in tmp), the
    checks, the results saved as rank{r}.pt (or the traceback as
    rank{r}.err)."""
    torch.set_num_threads(1)
    try:
        _join_group(rank, tmp, 'store', WORLD)
        torch.save(_checks(rank, tmp), os.path.join(tmp, f'rank{rank}.pt'))
    except BaseException:
        with open(os.path.join(tmp, f'rank{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def make_inputs(rng: np.random.RandomState):
    """The numpy batches of the three families (masks drawn here, the same
    for the port and JAX) and the stacks' tokens."""
    b = 4
    vmask = np.ones((b, 32), bool)
    vmask[:, :16] = False
    cmask = np.ones((b, 4), bool)
    for r in range(b):
        cmask[r, rng.choice(4, 2, replace=False)] = False
    conj_mask = np.ones((b, 32), bool)
    conj_mask[:, :18] = False
    batch = dict(
        vmae=(rng.rand(b, 2, 3, 32, 32).astype(np.float32), vmask),
        cmae=(rng.rand(b, 3, 32, 32).astype(np.float32), cmask),
        conj=(rng.rand(b, 3, 2, 32, 32).astype(np.float32), conj_mask,
              rng.randn(b, 6, 32, 1, 1).astype(np.float32),
              np.zeros((b, 4), bool)))
    tokens = {name: rng.randn(*shape, cfg['encoder_embed_dim']).astype(
        np.float32) for name, (cfg, shape) in STACKS.items()}
    return dict(batch=batch, tokens=tokens,
                n_vis=dict(vmae=16, cmae=2, conj=(18, 4)), counts=(2,))
