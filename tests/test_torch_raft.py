"""Port parity: RAFT (correlation pyramid, window lookup, convex upsampling,
the shared-frame-0 flow probe) against the JAX package on the CPU.

The lookup's plain version is held against both JAX lookups (the gather
formulation and the padded-level Pallas kernel in interpret mode) at
atol 1e-5; the lookup kernel itself is held against the plain version on
the card in test_torch_kernels_cuda.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.models.raft import corr as jcorr
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.models.raft import corr as tcorr
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import assert_close, t


def _level_and_coords(seed, n, h, w, lo=-8.0, span=None):
    rng = np.random.RandomState(seed)
    level = rng.randn(n, h, w).astype(np.float32)
    span = span or max(h, w) + 16
    x = (rng.rand(n) * span + lo).astype(np.float32)
    y = (rng.rand(n) * span + lo).astype(np.float32)
    return level, x, y


@pytest.mark.parametrize('h,w', [(28, 28), (7, 9), (3, 3)])
def test_window_lookup_plain_matches_jax(h, w):
    r = 4
    level, x, y = _level_and_coords(0, 24, h, w)
    lp = jcorr.pad_pyramid([jnp.asarray(level)], r)[0]
    ref = np.asarray(jcorr._window_lookup(lp, jnp.asarray(x), jnp.asarray(y),
                                          r, h, w))
    ref_k4 = np.asarray(jcorr._window_lookup_tpu(
        lp, jnp.asarray(x), jnp.asarray(y), r, h, w, interpret=True))
    before = dict(kernels.LAUNCHES)
    out = tcorr.window_lookup(t(level), t(x), t(y), r)
    assert kernels.LAUNCHES == before   # CPU tensors: plain version
    assert out.shape == (24, 2 * r + 1, 2 * r + 1)
    assert_close(out.numpy(), ref, 1e-5)
    assert_close(out.numpy(), ref_k4, 1e-5)


def test_pyramid_and_lookup_match_jax():
    """Correlation volume, odd-size pyramid floor (7x9 -> 3x4) and the
    4-level lookup in the reference's [x-offset, y-offset] order."""
    rng = np.random.RandomState(1)
    f1 = rng.randn(2, 7, 9, 16).astype(np.float32)
    f2 = rng.randn(2, 7, 9, 16).astype(np.float32)
    jc = jcorr.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2))
    tc = tcorr.all_pairs_correlation(t(f1), t(f2))
    assert_close(tc.numpy(), jc, 1e-5)
    jp = jcorr.build_pyramid(jc, 3)
    tp = tcorr.build_pyramid(tc, 3)
    assert [tuple(lv.shape) for lv in tp] == [lv.shape for lv in jp]
    for a, b in zip(tp, jp):
        assert_close(a.numpy(), b, 1e-5)
    coords = (rng.rand(2, 7, 9, 2) * 14 - 3).astype(np.float32)
    ref = jcorr.lookup_pyramid(jp, jnp.asarray(coords), 3)
    out = tcorr.lookup_pyramid(tp, t(coords), 3)
    assert_close(out.numpy(), ref, 1e-5)


@pytest.mark.parametrize('h,w,ref', [(4, 4, 'gather'), (7, 9, 'gather'),
                                     (8, 8, 'lanes')])
def test_lookup_pyramid_four_levels_match_jax(h, w, ref):
    """The lookup as RAFT calls it: four levels at r = 4, coordinates 8 px
    past every edge. 4x4 (a 32 px image: level 3 is 0x0) and 7x9 (level 3
    is 0x1) against the JAX gather path; 8x8 against the lanes kernel (K3)
    in interpret mode, which cannot take an empty level."""
    rng = np.random.RandomState(7)
    f1 = rng.randn(2, h, w, 16).astype(np.float32)
    f2 = rng.randn(2, h, w, 16).astype(np.float32)
    coords = (rng.rand(2, h, w, 2) * (max(h, w) + 16) - 8).astype(np.float32)
    jc = jcorr.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2))
    if ref == 'gather':
        want = jcorr.lookup_pyramid(jcorr.build_pyramid(jc, 4),
                                    jnp.asarray(coords), 4)
    else:
        want = jcorr.lookup_pyramid_lanes(jcorr.build_pyramid_lanes(jc, 4),
                                          jnp.asarray(coords), 4,
                                          force_kernel=True)
    tp = tcorr.build_pyramid(tcorr.all_pairs_correlation(t(f1), t(f2)), 4)
    before = dict(kernels.LAUNCHES)
    out = tcorr.lookup_pyramid(tp, t(coords), 4)
    assert kernels.LAUNCHES == before   # CPU tensors: plain version
    assert out.shape == (2, h, w, 4 * 81)
    assert_close(out.numpy(), want, 1e-5)
    assert torch.equal(tcorr.lookup_pyramid(tp, t(coords), 4, torch.bfloat16),
                       out.to(torch.bfloat16))


def test_convex_upsample_and_coords_grid_match_jax():
    rng = np.random.RandomState(2)
    flow = rng.randn(2, 3, 5, 2).astype(np.float32)
    mask = rng.randn(2, 3, 5, 9 * 64).astype(np.float32)
    ref = jraft.convex_upsample(jnp.asarray(flow), jnp.asarray(mask))
    assert_close(traft.convex_upsample(t(flow), t(mask)).numpy(), ref, 1e-5)
    np.testing.assert_array_equal(traft.coords_grid(2, 3, 5).numpy(),
                                  np.asarray(jraft.coords_grid(2, 3, 5)))


@pytest.mark.parametrize('block,stride,cin', [('ResidualBlock', 2, 16),
                                              ('BottleneckBlock', 2, 16),
                                              ('BottleneckBlock', 1, 32)])
def test_residual_blocks_match_jax(block, stride, cin):
    """One block with frozen batch norms at random statistics, JAX NHWC vs
    the port's NCHW, loaded strict through the bridge's conversion rules."""
    from counterfactualworldmodels_tpu.models.raft import layers as jl
    from counterfactualworldmodels_tpu_torch.models.raft import layers as tl
    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, 6, cin).astype(np.float32)
    jb = getattr(jl, block)(32, 'batch', stride)
    params = jb.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == 'var'
                         else 0.3 * rng.randn(*a.shape)).astype(np.float32),
        params)
    ref = jb.apply({'params': params}, jnp.asarray(x))
    n_conv = 2 if block == 'ResidualBlock' else 3
    sd = {}
    for i in range(1, n_conv + 1):
        weights._conv(sd, f'conv{i}', params[f'conv{i}'])
        weights._bn(sd, f'norm{i}', params[f'norm{i}'])
    if stride != 1:
        last = f'norm{n_conv + 1}'
        weights._conv(sd, 'downsample.0', params['downsample_conv'])
        weights._bn(sd, 'downsample.1', params[last])
        weights._bn(sd, last, params[last])
    tb = getattr(tl, block)(cin, 32, 'batch', stride)
    tb.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = tb(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(out.numpy(), ref, 1e-5)


def test_apply_raft_shared0_matches_jax():
    """RAFT(iters=2) at 32x32 with JAX-initialised weights through the
    bridge. atol 1e-3 px: two GRU iterations of f32 convolutions summed in
    another order feed back through the lookup coordinates."""
    jmodel = jraft.RAFT(iters=2)
    params = jraft.init_raft_params(jmodel, jax.random.PRNGKey(0), hw=32)
    tmodel = traft.RAFT(iters=2, device='cpu')
    tmodel.load_state_dict(weights.raft_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    rng = np.random.RandomState(3)
    x0 = rng.rand(1, 3, 32, 32).astype(np.float32)
    x1 = rng.rand(3, 3, 32, 32).astype(np.float32)
    video = np.concatenate([np.repeat(x0[:, None], 3, 0), x1[:, None]], 1)
    ref = np.asarray(jraft.apply_raft_shared0(jmodel, params,
                                              jnp.asarray(video), 2, True))
    out = traft.apply_raft_shared0(tmodel, t(video), 2, True)
    assert out.shape == ref.shape == (3, 1, 2, 32, 32)
    assert_close(out.numpy(), ref, 1e-3)
    # sharing the frame-0 encoders equals running every pair
    per_pair = traft.apply_raft_video(tmodel, t(video), False, 2, True)
    assert_close(out.numpy(), per_pair.numpy(), 1e-4)

