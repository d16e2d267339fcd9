"""Port parity: the small RAFT, the output_dim head (the keypoint predictor)
and the rest of models/raft against the JAX package on the CPU.

Weights are initialised in JAX and carried over by utils/weights.py. Each
module alone within 1e-5 (one pass of f32 convolutions summed in another
order; the small encoder also within 1e-5 relative, for its instance norms
over 16x16 maps); upflow8 within 1e-5; the whole model (2 GRU iterations,
whose output feeds back through the lookup coordinates) within 1e-3 px, as
tests/test_torch_raft.py holds the large model.
"""
import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from counterfactualworldmodels_tpu.models.raft import layers as jl
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.utils.torch_export import export_raft
from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.models.raft import layers as tl
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import assert_close, t


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# under jit: the same values as an eager call, with one compile instead of
# an op-by-op forward
_init_raft = jax.jit(jraft.init_raft_params, static_argnums=(0, 2))


def _flat_sd(tree, prefix=''):
    """A flax tree of convs and norms -> the port's state dict, path
    components joined by '.' (modules whose names agree on both sides)."""
    sd = {}
    for k, v in tree.items():
        p = prefix + k
        if 'kernel' in v:
            weights._conv(sd, p, v)
        elif 'mean' in v:
            weights._bn(sd, p, v)
        elif 'scale' in v:
            sd[p + '.weight'], sd[p + '.bias'] = t(v['scale']), t(v['bias'])
        else:
            sd.update(_flat_sd(v, p + '.'))
    return sd


def _randomize(params, rng):
    """Random values everywhere (variances positive), so that norm
    statistics and biases are exercised too."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key
                         == 'var' else 0.3 * rng.randn(*a.shape)
                         ).astype(np.float32), params)


def _nhwc(x):
    return t(x).permute(0, 3, 1, 2)


def _back(y):
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize('norm', ['batch', 'instance', 'group', 'none'])
@pytest.mark.parametrize('block', ['ResidualBlock', 'BottleneckBlock'])
def test_blocks_in_every_norm_match_jax(block, norm):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 6, 16).astype(np.float32)
    jb = getattr(jl, block)(32, norm, 2)
    params = _randomize(jb.init(jax.random.PRNGKey(0),
                                jnp.asarray(x))['params'], rng)
    ref = jb.apply({'params': params}, jnp.asarray(x))
    n_conv = 2 if block == 'ResidualBlock' else 3
    sd = {}
    for i in range(1, n_conv + 1):
        weights._conv(sd, f'conv{i}', params[f'conv{i}'])
    weights._conv(sd, 'downsample.0', params['downsample_conv'])
    norms = [f'norm{i}' for i in range(1, n_conv + 2)]
    for name in norms:
        if norm in ('batch', 'group'):
            alias = (['downsample.1'] if name == norms[-1] else []) + [name]
            for a in alias:
                sd.update(_flat_sd({a: params[name]}))
    tb = getattr(tl, block)(16, 32, norm, 2)
    tb.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = _back(tb(_nhwc(x)))
    assert_close(out, ref, 1e-5)


def test_group_norm_uses_flax_epsilon():
    gn = tl.make_norm('group', 32)
    assert isinstance(gn, torch.nn.GroupNorm)
    assert (gn.num_groups, gn.eps) == (4, 1e-6)
    x = np.random.RandomState(4).randn(2, 3, 3, 32).astype(np.float32) * 1e-3
    jg = fnn.GroupNorm(num_groups=4)
    ref = jg.apply(jg.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                   jnp.asarray(x))
    with torch.no_grad():
        assert_close(_back(gn(_nhwc(x))), ref, 1e-5)
    assert isinstance(tl.make_norm('none', 8), torch.nn.Identity)


@pytest.mark.parametrize('norm,out_dim', [('instance', 128), ('none', 160)])
def test_small_encoder_matches_jax(norm, out_dim):
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    je = jl.SmallEncoder(out_dim, norm)
    params = je.init(jax.random.PRNGKey(1), jnp.asarray(x))['params']
    ref = je.apply({'params': params}, jnp.asarray(x))
    sd = {}
    weights._encoder(sd, 'e', params, norm, bottleneck=True)
    te = tl.SmallEncoder(out_dim, norm)
    te.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        assert_close(_back(te(_nhwc(x))), ref, 1e-5, 1e-5)


def test_small_update_parts_match_jax():
    """ConvGRU, SmallMotionEncoder and SmallUpdateBlock (no mask)."""
    rng = np.random.RandomState(6)
    h = np.tanh(rng.randn(2, 4, 5, 96)).astype(np.float32)
    inp = rng.rand(2, 4, 5, 64).astype(np.float32)
    corr = rng.randn(2, 4, 5, 196).astype(np.float32)
    flow = rng.randn(2, 4, 5, 2).astype(np.float32)
    x = rng.randn(2, 4, 5, 146).astype(np.float32)
    cases = [(jl.ConvGRU(96), tl.ConvGRU(96, 146), (h, x)),
             (jl.SmallMotionEncoder(4, 3), tl.SmallMotionEncoder(4, 3),
              (flow, corr)),
             (jl.SmallUpdateBlock(4, 3, 96), tl.SmallUpdateBlock(4, 3, 96),
              (h, inp, corr, flow))]
    for jm, tm, args in cases:
        jargs = [jnp.asarray(a) for a in args]
        params = jm.init(jax.random.PRNGKey(2), *jargs)['params']
        params = jax.tree_util.tree_map(
            lambda a: (0.1 * rng.randn(*a.shape)).astype(np.float32), params)
        ref = jm.apply({'params': params}, *jargs)
        tm.load_state_dict(_flat_sd(params), strict=True)
        with torch.no_grad():
            out = tm(*[_nhwc(a) for a in args])
        if isinstance(ref, tuple):
            assert out[1] is None and ref[1] is None
            for o, r in ((out[0], ref[0]), (out[2], ref[2])):
                assert_close(_back(o), r, 1e-5)
        else:
            assert_close(_back(out), ref, 1e-5)


@pytest.mark.parametrize('h,w', [(4, 5), (1, 3), (7, 7)])
def test_upflow8_matches_jax(h, w):
    flow = np.random.RandomState(7).randn(2, h, w, 3).astype(np.float32)
    ref = jraft.upflow8(jnp.asarray(flow))
    out = traft.upflow8(t(flow))
    assert tuple(out.shape) == ref.shape == (2, 8 * h, 8 * w, 3)
    assert_close(out.numpy(), ref, 1e-5)


def test_convex_upsample_one_channel_matches_jax():
    """The large keypoint head upsamples a C = 1 map convexly."""
    rng = np.random.RandomState(8)
    out_map = rng.randn(2, 3, 5, 1).astype(np.float32)
    mask = rng.randn(2, 3, 5, 9 * 64).astype(np.float32)
    ref = jraft.convex_upsample(jnp.asarray(out_map), jnp.asarray(mask))
    out = traft.convex_upsample(t(out_map), t(mask))
    assert tuple(out.shape) == ref.shape == (2, 24, 40, 1)
    assert_close(out.numpy(), ref, 1e-5)


@pytest.mark.parametrize('mode', ['sintel', 'kitti'])
def test_input_padder_matches_jax(mode):
    x = np.random.RandomState(9).rand(2, 3, 3, 21, 30).astype(np.float32)
    jp = jraft.InputPadder(x.shape, mode)
    tp = traft.InputPadder(x.shape, mode)
    (ref,), (out,) = jp.pad(jnp.asarray(x)), tp.pad(t(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tp.unpad(out).numpy(), x)


def _raft_pair(small, output_dim, hw, seed=0):
    jm = jraft.RAFT(iters=2, small=small, output_dim=output_dim)
    params = _np_tree(_init_raft(jm, jax.random.PRNGKey(seed), hw))
    tm = traft.RAFT(iters=2, small=small, output_dim=output_dim,
                    device='cpu')
    sd = weights.raft_state_dict_from_jax(params)
    # the bridge writes the JAX exporter's layout, key for key
    assert set(sd) == set(export_raft(params, small=small))
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm


def test_small_raft_matches_jax():
    """RAFT(small=True) at 32 px: radius 3, the 'none'-norm context encoder,
    upflow8; the shared frame 0 against JAX, and against every pair."""
    jm, params, tm = _raft_pair(True, None, 32)
    assert tm.radius == 3 and (tm.hidden_dim, tm.context_dim) == (96, 64)
    rng = np.random.RandomState(10)
    x0 = rng.rand(1, 3, 32, 32).astype(np.float32)
    x1 = rng.rand(3, 3, 32, 32).astype(np.float32)
    video = np.concatenate([np.repeat(x0[:, None], 3, 0), x1[:, None]], 1)
    ref = np.asarray(jraft.apply_raft_shared0(jm, params, jnp.asarray(video),
                                              2, True))
    before = dict(kernels.LAUNCHES)
    out = traft.apply_raft_shared0(tm, t(video), 2, True)
    assert kernels.LAUNCHES == before   # CPU tensors: plain lookup
    assert out.shape == ref.shape == (3, 1, 2, 32, 32)
    assert_close(out.numpy(), ref, 1e-3)
    per_pair = traft.apply_raft_video(tm, t(video), False, 2, True)
    assert_close(out.numpy(), per_pair.numpy(), 1e-4)


def test_small_keypoint_head_matches_jax():
    """RAFT(small=True, output_dim=1) as the keypoint predictor: frame 0
    paired with itself through apply_raft_video, [B, 1, 1, H, W]: the head
    (192 hidden) on the GRU state, upsampled by upflow8. flow_lr stays the
    flow: the same weights without the head give the same flow_lr. (The
    large head is held against JAX in tests/test_torch_movability.py.)"""
    jm, params, tm = _raft_pair(True, 1, 32, seed=1)
    assert tm.output_block[0].weight.shape[0] == 192
    x = np.random.RandomState(11).rand(2, 2, 3, 32, 32).astype(np.float32)
    ref = np.asarray(jraft.apply_raft_video(
        jm, params, jnp.asarray(x[:, :1]), False, 2, True))
    out = traft.RaftKeypointPredictor(tm)(t(x))
    assert out.shape == ref.shape == (2, 1, 1, 32, 32)
    assert_close(out.numpy(), ref, 1e-3)
    flow_only = traft.RAFT(iters=2, small=True, device='cpu')
    flow_only.load_state_dict({k: v for k, v in tm.state_dict().items()
                               if not k.startswith('output_block')},
                              strict=True)
    with torch.no_grad():
        a = tm(t(x[:, 0] * 255), t(x[:, 1] * 255))
        b = flow_only(t(x[:, 0] * 255), t(x[:, 1] * 255))
    assert a[0].shape == (2, 2, 4, 4) and a[1].shape == (2, 1, 32, 32)
    assert torch.equal(a[0], b[0])


@pytest.mark.parametrize('small', [True, False], ids=['small', 'large'])
def test_keypoint_head_keeps_the_compute_dtype(small):
    """In bf16 the head's map is upsampled and returned in bf16 and flow_lr
    in f32, as the JAX package does (its dtypes read by eval_shape, with no
    compile); the map is finite, of the flow's shape."""
    img = jnp.zeros((1, 3, 32, 32), jnp.float32)
    jm = jraft.RAFT(iters=1, small=small, output_dim=1, dtype=jnp.bfloat16)
    ref = jax.eval_shape(lambda: jm.init_with_output(
        jax.random.PRNGKey(0), img, img, 1)[0])
    tm = weights.init_raft(traft.RAFT(iters=1, small=small, output_dim=1,
                                      dtype=torch.bfloat16, device='cpu'),
                           torch.Generator().manual_seed(0))
    x = np.random.RandomState(12).rand(1, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        out = tm(t(255 * x), t(255 * x))
    for o, r in zip(out, ref):
        assert o.dtype == getattr(torch, r.dtype.name)
        assert tuple(o.shape) == r.shape
    assert out[1].dtype == torch.bfloat16 and out[0].dtype == torch.float32
    assert bool(torch.isfinite(out[1]).all())


def _zero_params(jm):
    """The parameter tree of a JAX RAFT, zeros (shapes only, no compile)."""
    img = jnp.zeros((1, 3, 32, 32), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img, img,
                                            1)['params'])
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


@pytest.mark.parametrize('small,output_dim', [(True, None), (True, 1),
                                              (False, 1)])
def test_init_raft_fills_every_form(small, output_dim):
    """Seeded random weights for the small model and the heads: every
    convolution drawn, norms at identity, the JAX exporter's key set."""
    tm = weights.init_raft(traft.RAFT(iters=1, small=small,
                                      output_dim=output_dim, device='cpu'),
                           torch.Generator().manual_seed(0))
    jm = jraft.RAFT(iters=1, small=small, output_dim=output_dim)
    params = _zero_params(jm)
    assert set(tm.state_dict()) == set(export_raft(params, small=small))
    assert set(tm.state_dict()) == set(weights.raft_state_dict_from_jax(
        params))
    for name, p in tm.named_parameters():
        if name.endswith('weight') and p.dim() == 4:
            assert float(p.std()) > 0, name
    again = weights.init_raft(traft.RAFT(iters=1, small=small,
                                         output_dim=output_dim, device='cpu'),
                              torch.Generator().manual_seed(0))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k
