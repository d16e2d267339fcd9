"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device (and nvcc, to build the kernels); skips without one.
This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

bf16 attention runs on the tensor-core kernels (``*_sm90``: wgmma, shapes
cut into 64- and 128-row tiles), f32 on the CUDA-core ones; the shapes
below cross those tile edges (Nk under one tile, Nq and Nk one past a
boundary) at every head dim.

Tolerances: f32 2e-5 / 3e-5 (the JAX kernel tests' bounds: sums in another
order); bf16 2e-2 (outputs of magnitude ~1 differ by a couple of bf16 ulps:
the kernel rounds the unnormalised probabilities to bf16 before P.V, as
the JAX kernel does, where the plain version rounds the normalised ones);
the lookup 1e-5 (sums in another order), and its bf16 output bitwise
the f32 output cast. The training pair: the lse at 1e-4 and the f32 gradients
at atol 2e-4 / rtol 1e-4 (tests/test_flash_attention.py's bounds); bf16
gradients within 2e-2 of their largest magnitude.
"""
import numpy as np
import pytest
import torch

from counterfactualworldmodels_tpu_torch import kernels
from counterfactualworldmodels_tpu_torch.models.raft import corr
from counterfactualworldmodels_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    return torch.device('cuda')


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize('dtype,atol', [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_matches_plain(dev, dtype, atol):
    rng = np.random.RandomState(0)
    for (b, h, nq, nk, d) in [(2, 3, 100, 77, 16), (1, 2, 64, 64, 32),
                              (2, 2, 130, 200, 64), (1, 2, 70, 90, 128),
                              (1, 2, 100, 20, 64), (1, 2, 129, 65, 16),
                              (1, 2, 129, 65, 32), (2, 2, 129, 129, 64),
                              (1, 2, 257, 65, 128)]:
        q = _rand(rng, b, h, nq, d, scale=d ** -0.5).to(dev, dtype)
        k, v = (_rand(rng, b, h, nk, d).to(dev, dtype) for _ in range(2))
        before = kernels.LAUNCHES['flash_attention']
        out = fa.flash_attention(q, k, v)
        assert kernels.LAUNCHES['flash_attention'] == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        assert _err(out, fa._chunked_dense_attention(q, k, v)) <= atol


@pytest.mark.parametrize('dtype,atol', [(torch.float32, 3e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_prefix_kernel_matches_plain(dev, dtype, atol):
    """Shared and stacked prefixes, weights (1, 1), (16, 16), (1, 4) and
    (4, 1), a prefix under one key tile and panels one past a tile
    boundary, every head dim."""
    rng = np.random.RandomState(1)
    for s0, n0, n1, w, d in [(1, 33, 65, (1.0, 1.0), 64),
                             (1, 33, 65, (16.0, 16.0), 64),
                             (3, 33, 65, (1.0, 4.0), 64),
                             (1, 33, 129, (1.0, 4.0), 64),
                             (1, 196, 196, (16.0, 16.0), 64),
                             (1, 100, 129, (16.0, 16.0), 32),
                             (1, 300, 20, (4.0, 1.0), 128),
                             (3, 129, 65, (1.0, 4.0), 16)]:
        q = _rand(rng, 3, 2, 50, d, scale=d ** -0.5).to(dev, dtype)
        k0, v0 = (_rand(rng, s0, 2, n0, d).to(dev, dtype) for _ in range(2))
        k1, v1 = (_rand(rng, 3, 2, n1, d).to(dev, dtype) for _ in range(2))
        before = kernels.LAUNCHES['flash_attention_prefix']
        out = fa.flash_attention_prefix(q, k0, v0, k1, v1, *w)
        assert kernels.LAUNCHES['flash_attention_prefix'] == before + 1
        ref = fa._dense_two_source(q, k0, v0, k1, v1, *w)
        assert _err(out, ref) <= atol, (s0, n0, n1, w, d)


def test_attention_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros(1, 2, 8, 64, device=dev)
    with pytest.raises(ValueError, match='contiguous'):
        fa.flash_attention(q, q.transpose(2, 3).contiguous().transpose(2, 3),
                           q)
    with pytest.raises(ValueError, match='mixed dtypes'):
        fa.flash_attention(q, q.bfloat16(), q)
    q48 = torch.zeros(1, 2, 8, 48, device=dev)
    with pytest.raises(ValueError, match='head dim'):
        fa.flash_attention(q48, q48, q48)


def test_window_lookup_kernel_matches_plain(dev):
    rng = np.random.RandomState(2)
    for (h, w) in [(28, 28), (7, 9), (3, 3), (0, 0)]:
        level = _rand(rng, 300, h, w).to(dev)
        x = torch.from_numpy((rng.rand(300) * (w + 16) - 8).astype(np.float32)).to(dev)
        y = torch.from_numpy((rng.rand(300) * (h + 16) - 8).astype(np.float32)).to(dev)
        before = kernels.LAUNCHES['window_lookup']
        out = corr.window_lookup(level, x, y, 4)
        assert kernels.LAUNCHES['window_lookup'] == before + 1
        ref = corr._window_lookup(corr.pad_pyramid([level], 4)[0], x, y, 4,
                                  h, w)
        assert _err(out, ref) <= 1e-5
    with pytest.raises(ValueError, match='float32'):
        corr.window_lookup(level.double(), x.double(), y.double(), 4)


@pytest.mark.parametrize('radius', [3, 4])
@pytest.mark.parametrize('levels', [1, 2, 3, 4])
def test_lookup_pyramid_kernel_matches_plain(dev, levels, radius):
    """All levels in one launch, against the plain path, with query counts
    that are no multiple of the kernel's 16-query tile, coordinates 8 px
    past every edge, odd level sizes (7x9 -> 3x4 -> 1x2 -> 0x1), a 0x0
    level (4x4 -> 2x2 -> 1x1 -> 0x0) and the dispatch's 28x28. The bf16
    output is bitwise the f32 output cast."""
    rng = np.random.RandomState(10 * levels + radius)
    p = 2 * radius + 1
    for b, h, w, h2, w2 in [(1, 5, 7, 7, 9), (2, 3, 3, 4, 4),
                            (1, 3, 37, 28, 28)]:
        pyramid = corr.build_pyramid(_rand(rng, b, h, w, h2, w2).to(dev),
                                     levels)
        coords = torch.from_numpy((rng.rand(b, h, w, 2) * (max(h2, w2) + 16)
                                   - 8).astype(np.float32)).to(dev)
        before = kernels.LAUNCHES['window_lookup']
        out = corr.lookup_pyramid(pyramid, coords, radius)
        assert kernels.LAUNCHES['window_lookup'] == before + 1
        assert out.dtype == torch.float32
        assert out.shape == (b, h, w, levels * p * p)
        ref = corr._lookup_pyramid(pyramid, coords, radius)
        assert _err(out, ref) <= 1e-5, (b, h, w, h2, w2)
        out_bf16 = corr.lookup_pyramid(pyramid, coords, radius,
                                       torch.bfloat16)
        assert kernels.LAUNCHES['window_lookup'] == before + 2
        assert out_bf16.dtype == torch.bfloat16
        assert torch.equal(out_bf16, out.to(torch.bfloat16))


def test_lookup_pyramid_kernel_rejects_what_it_does_not_take(dev):
    level = torch.zeros(6, 4, 4, device=dev)
    coords = torch.zeros(1, 2, 3, 2, device=dev)
    with pytest.raises(ValueError, match='5 levels'):
        corr.lookup_pyramid([level] * 5, coords, 4)
    with pytest.raises(ValueError, match='float32'):
        corr.lookup_pyramid([level, level.double()], coords, 4)
    with pytest.raises(ValueError, match='float32'):
        corr.lookup_pyramid([level], coords.double(), 4)
    with pytest.raises(ValueError, match='radius'):
        corr.lookup_pyramid([level], coords, 5)
    with pytest.raises(ValueError, match='output dtype'):
        corr.lookup_pyramid([level], coords, 4, torch.float16)
    with pytest.raises(ValueError, match='contiguous'):
        corr.lookup_pyramid([level], coords.transpose(1, 2).contiguous()
                            .transpose(1, 2), 4)
    with pytest.raises(ValueError, match='level'):
        corr.lookup_pyramid([torch.zeros(5, 4, 4, device=dev)], coords, 4)


_BWD_SHAPES = [(2, 3, 100, 77, 16), (1, 2, 64, 64, 32), (2, 2, 130, 200, 64),
               (1, 2, 70, 90, 128), (1, 2, 200, 333, 64), (1, 2, 100, 20, 32),
               (1, 2, 129, 65, 128), (2, 2, 129, 129, 16)]


def _grad_inputs(rng, dev, dtype, b, h, nq, nk, d):
    q = _rand(rng, b, h, nq, d, scale=d ** -0.5).to(dev, dtype)
    k, v = (_rand(rng, b, h, nk, d).to(dev, dtype) for _ in range(2))
    do = _rand(rng, b, h, nq, d).to(dev, dtype)
    return q, k, v, do


@pytest.mark.parametrize('dtype,atol', [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_flash_attention_lse_kernel_matches_plain(dev, dtype, atol):
    rng = np.random.RandomState(3)
    for (b, h, nq, nk, d) in _BWD_SHAPES:
        q, k, v, _ = _grad_inputs(rng, dev, dtype, b, h, nq, nk, d)
        before = kernels.LAUNCHES['flash_attention_lse']
        out, lse = fa._flash_forward_lse(q, k, v)
        assert kernels.LAUNCHES['flash_attention_lse'] == before + 1
        ref, ref_lse = fa._chunked_dense_attention(q, k, v, with_lse=True)
        assert lse.dtype == torch.float32 and lse.shape == (b, h, nq)
        assert _err(out, ref) <= atol
        assert torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain(dev, dtype):
    rng = np.random.RandomState(4)
    for (b, h, nq, nk, d) in _BWD_SHAPES:
        q, k, v, do = _grad_inputs(rng, dev, dtype, b, h, nq, nk, d)
        out, lse = fa._chunked_dense_attention(q, k, v, with_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        before = kernels.LAUNCHES['flash_attention_bwd']
        got = fa._flash_backward(q, k, v, do, lse, delta)
        assert kernels.LAUNCHES['flash_attention_bwd'] == before + 1
        ref = fa._chunked_attention_bwd(q, k, v, do, lse, delta)
        for name, a, r in zip('qkv', got, ref):
            assert a.dtype == dtype and a.shape == r.shape, name
            if dtype == torch.float32:
                assert torch.allclose(a, r, atol=2e-4, rtol=1e-4), name
            else:
                assert _err(a, r) <= 2e-2 * float(r.float().abs().max()), name


def test_flash_attention_bwd_kernel_is_deterministic(dev):
    rng = np.random.RandomState(5)
    for shape in [(2, 4, 333, 333, 64), (1, 2, 129, 65, 128),
                  (2, 2, 200, 77, 32)]:
        q, k, v, do = _grad_inputs(rng, dev, torch.bfloat16, *shape)
        out, lse = fa._flash_forward_lse(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        first = fa._flash_backward(q, k, v, do, lse, delta)
        second = fa._flash_backward(q, k, v, do, lse, delta)
        assert all(torch.equal(a, b) for a, b in zip(first, second)), shape


def _device_kernel_names(fn):
    """The names of the device kernels ``fn`` launches, by torch.profiler.
    A later profiler session in a process sometimes records the launches
    but no device kernel at all; such a session is taken again, up to three
    times (a session with kernels is never retaken)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return ' '.join(names)


def test_bf16_attention_runs_on_the_tensor_core_kernels(dev):
    """bf16 calls launch the wgmma kernels, f32 calls the CUDA-core ones."""
    rng = np.random.RandomState(8)
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = _grad_inputs(rng, dev, dtype, 1, 2, 130, 130, 64)

        def calls():
            out, lse = fa._flash_forward_lse(q, k, v)
            fa.flash_attention_prefix(q, k, v, k, v, 1.0, 4.0)
            fa._flash_backward(q, k, v, do, lse,
                               (do.float() * out.float()).sum(-1))

        names[dtype] = _device_kernel_names(calls)
    for kernel in ('attention_fwd_sm90', 'dkdv_sm90', 'dq_sm90'):
        assert kernel in names[torch.bfloat16]
        assert kernel not in names[torch.float32]
    for kernel in ('attention_kernel', 'dkdv_kernel', 'dq_kernel'):
        assert kernel in names[torch.float32]
        assert kernel not in names[torch.bfloat16]


def test_flash_attention_gradients_come_from_k6(dev):
    """The fault this guards against: a kernel output without grad_fn
    trains every weight upstream of attention with a zero gradient."""
    rng = np.random.RandomState(6)
    q, k, v, do = _grad_inputs(rng, dev, torch.float32, 1, 2, 150, 150, 64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kernels.reset_launches()
    out = fa.flash_attention(*leaves)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, do)
    assert kernels.LAUNCHES['flash_attention_lse'] == 1
    assert kernels.LAUNCHES['flash_attention_bwd'] == 1
    assert kernels.LAUNCHES['flash_attention'] == 0
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(fa._chunked_dense_attention(*ref_leaves),
                              ref_leaves, do)
    for name, a, r in zip('qkv', grads, ref):
        assert torch.allclose(a, r, atol=2e-4, rtol=1e-4), name
    with torch.no_grad():
        fa.flash_attention(*leaves)
    assert kernels.LAUNCHES['flash_attention'] == 1


def test_flash_attention_prefix_refuses_a_gradient_on_the_card(dev):
    z = torch.zeros
    q = z(2, 2, 8, 64, device=dev, requires_grad=True)
    kv = [z(n, 2, 8, 64, device=dev) for n in (1, 1, 2, 2)]
    with pytest.raises(RuntimeError, match='no backward'):
        fa.flash_attention_prefix(q, *kv)
    with torch.no_grad():
        assert fa.flash_attention_prefix(q, *kv).shape == q.shape


def _fixed_draws(gen, seed):
    """numpy-seeded draws in place of the generator's, on its device."""
    rng = np.random.RandomState(seed)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(gen.device)

    gen._draw_shifts = lambda s: tensor(rng.randint(-2, 3, (s, 2)))
    gen._draw_prompt_noise = lambda rows, n: tensor(
        (rng.rand(rows, n) * 0.999).astype(np.float32))
    gen._draw_patch_indices = lambda p, k: tensor(
        rng.randint(0, p.shape[1], (p.shape[0], k)))
    return gen


@pytest.mark.parametrize('engine', ['fast', 'exact'])
def test_flow_generator_on_the_card_matches_the_cpu(dev, engine):
    """FlowGenerator at the small configuration in f32 (TF32 off), from the
    same weights and draws on the card and on the CPU: masks equal, videos
    within 1e-4, flows within 1e-3 px; on the card the path's kernels ran
    (fast: K1 for the prefix, K2 for the suffix decoder, the lookup; exact:
    K1 in every block, the lookup), on the CPU none."""
    from counterfactualworldmodels_tpu_torch.models import vmae
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.pipelines.segmentation import (
        FlowGenerator)
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = vmae.PretrainVisionTransformer(
        img_size=(32, 32), patch_size=(4, 4), encoder_embed_dim=64,
        encoder_depth=3, encoder_num_heads=4, decoder_embed_dim=32,
        decoder_depth=2, decoder_num_heads=2, num_frames=2, qkv_bias=True)
    sd = weights.init_vmae_state_dict(model, torch.Generator().manual_seed(0))
    raft_cpu = weights.init_raft(RAFT(iters=2, device='cpu'),
                                 torch.Generator().manual_seed(1))
    rng = np.random.RandomState(6)
    x = rng.rand(1, 3, 32, 32).astype(np.float32)
    outs = {}
    for d in ('cpu', 'cuda'):
        raft = raft_cpu
        if d == 'cuda':
            raft = RAFT(iters=2, device=d)
            raft.load_state_dict(raft_cpu.state_dict(), strict=True)
        gen = _fixed_draws(FlowGenerator(
            predictor=model, params=sd, flow_model=raft, raft_iters=2,
            imagenet_normalize_inputs=True, engine=engine, device=d), 7)
        kernels.reset_launches()
        flows, active, _ = gen.sample_counterfactual_motion_map(
            x, num_samples=4, sample_batch_size=2, do_filter=False)
        y, f = gen.predict_counterfactual_videos_and_flows(
            x, active, num_samples=4, sample_batch_size=4)
        outs[d] = ([v.cpu() for v in (flows, active, y, f)],
                   dict(kernels.LAUNCHES))
    (c, lc), (g, lg) = outs['cpu'], outs['cuda']
    assert torch.equal(c[1], g[1])
    assert _err(c[2], g[2]) <= 1e-4
    assert max(_err(c[0], g[0]), _err(c[3], g[3])) <= 1e-3
    assert not any(lc.values())
    depth = model.encoder_depth + model.decoder_depth
    # three chunks of prompts (two of the motion map, one of the call after
    # it), each with a 2-iteration RAFT: 2 lookups per chunk
    if engine == 'fast':
        # one scene: its prefix once (K1 in every block), then the suffix
        # decoder (K2 in every decoder block) per chunk
        want = dict(flash_attention=depth,
                    flash_attention_prefix=3 * model.decoder_depth,
                    window_lookup=3 * 2)
    else:
        # apply_vmae per chunk (K1 in every block)
        want = dict(flash_attention=3 * depth, window_lookup=3 * 2)
    assert lg == dict({k: 0 for k in lg}, **want), lg


def _raft_on_both(cpu_model_fn, monkeypatch):
    """A RAFT with seeded weights on the CPU and the same weights on the
    card, and a spy that records the radius of every lookup call."""
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    from counterfactualworldmodels_tpu_torch.utils import weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = weights.init_raft(cpu_model_fn('cpu'),
                            torch.Generator().manual_seed(1))
    gpu = cpu_model_fn('cuda')
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    radii = []
    real = traft.lookup_pyramid

    def spy(pyramid, coords, radius, *a):
        radii.append(radius)
        return real(pyramid, coords, radius, *a)

    monkeypatch.setattr(traft, 'lookup_pyramid', spy)
    return cpu, gpu, radii


def test_small_raft_runs_the_radius_3_lookup(dev, monkeypatch):
    """RAFT(small=True) at 64 px, 2 iterations, f32 (TF32 off): flows within
    1e-3 px of the CPU's; on the card one radius-3 lookup launch per
    iteration, on the CPU none."""
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    cpu, gpu, radii = _raft_on_both(
        lambda d: traft.RAFT(iters=2, small=True, device=d), monkeypatch)
    rng = np.random.RandomState(9)
    video = torch.from_numpy(rng.rand(3, 2, 3, 64, 64).astype(np.float32))
    kernels.reset_launches()
    ref = traft.apply_raft_shared0(cpu, video)
    assert kernels.LAUNCHES['window_lookup'] == 0
    out = traft.apply_raft_shared0(gpu, video.to(dev))
    assert kernels.LAUNCHES['window_lookup'] == 2
    assert radii == [3] * 4
    assert _err(out.cpu(), ref) <= 1e-3


def test_keypoint_raft_on_the_card_matches_the_cpu(dev, monkeypatch):
    """RAFT(output_dim=1) (the large model's keypoint head, convex
    upsampling of one channel) through RaftKeypointPredictor at 64 px: the
    map within 1e-4 of the CPU's, one radius-4 lookup per iteration."""
    from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
    cpu, gpu, radii = _raft_on_both(
        lambda d: traft.RAFT(iters=2, output_dim=1, device=d), monkeypatch)
    x = torch.from_numpy(np.random.RandomState(10).rand(
        2, 2, 3, 64, 64).astype(np.float32))
    ref = traft.RaftKeypointPredictor(cpu)(x)
    kernels.reset_launches()
    out = traft.RaftKeypointPredictor(gpu)(x.to(dev))
    assert kernels.LAUNCHES['window_lookup'] == 2 and radii == [4] * 4
    assert out.shape == ref.shape == (2, 1, 1, 64, 64)
    assert _err(out.cpu(), ref) <= 1e-4


@pytest.mark.parametrize('dtype,atol', [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_attention_kernels_at_the_imu_path_shapes(dev, dtype, atol):
    """K1 at the ViT-B 4x4 prefix [1,12,3136,3136,64] and at the IMU
    stream's head dim 32 (the context encoder and decoder of the exact
    engine: [4,12,25,25,32], [4,6,50,50,32]; flow2imu's one visible dummy
    token [1,12,1,1,32]), and K2 at the conjoined decoder suffix
    [16,6,3200; 3136+3200,64], against their plain versions. bf16 within
    atol of the plain output's largest magnitude, as chip_smoke.py."""
    rng = np.random.RandomState(3)
    for (b, h, nq, nk, d) in [(1, 12, 3136, 3136, 64), (4, 12, 25, 25, 32),
                              (4, 6, 50, 50, 32), (1, 12, 1, 1, 32)]:
        q = _rand(rng, b, h, nq, d, scale=d ** -0.5).to(dev, dtype)
        k, v = (_rand(rng, b, h, nk, d).to(dev, dtype) for _ in range(2))
        ref = fa._chunked_dense_attention(q, k, v)
        tol = atol if dtype == torch.float32 else atol * float(
            ref.float().abs().max())
        assert _err(fa.flash_attention(q, k, v), ref) <= tol, (b, h, nq, d)
    s, h, nq, n0, n1 = 16, 6, 3200, 3136, 3200
    q = _rand(rng, s, h, nq, 64, scale=0.125).to(dev, dtype)
    k0, v0 = (_rand(rng, 1, h, n0, 64).to(dev, dtype) for _ in range(2))
    k1, v1 = (_rand(rng, s, h, n1, 64).to(dev, dtype) for _ in range(2))
    before = kernels.LAUNCHES['flash_attention_prefix']
    out = fa.flash_attention_prefix(q, k0, v0, k1, v1)
    ref = fa._dense_two_source(q, k0, v0, k1, v1, 1.0, 1.0)
    tol = (3e-5 if dtype == torch.float32
           else atol * float(ref.float().abs().max()))
    assert _err(out, ref) <= tol
    assert kernels.LAUNCHES['flash_attention_prefix'] == before + 1


def _small_imu(d):
    """The small IMU-conditioned predictor and flow2imu (every head dim 16)
    with seeded weights made on the CPU, and a RAFT-2, on device d."""
    from counterfactualworldmodels_tpu_torch.models import conjoined as C
    from counterfactualworldmodels_tpu_torch.models.raft.raft import RAFT
    from counterfactualworldmodels_tpu_torch.utils import weights
    ctx = dict(is_imu=True, in_chans=6, sequence_length=48, imu_tubelet=8,
               encoder_embed_dim=32, encoder_depth=2, encoder_num_heads=2,
               decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=2,
               decoder_num_classes=48, mlp_ratio=2.0)
    main = dict(img_size=(64, 64), patch_size=(8, 8), encoder_embed_dim=64,
                encoder_depth=2, encoder_num_heads=4, decoder_embed_dim=32,
                decoder_depth=2, decoder_num_heads=2, mlp_ratio=2.0)
    wrappers = []
    for i, (m, c, kw) in enumerate((
            (dict(in_chans=3, num_frames=2, padded=True,
                  max_padding_tokens=8),
             dict(concat_dummy_token=False, padded=True,
                  max_padding_tokens=6), dict(main_input='rgb01')),
            (dict(in_chans=7, num_frames=1, decoder_num_classes=448),
             dict(concat_dummy_token=True), dict(
                 main_input='flowback_rgb01',
                 main_input_kwargs={'iters': 2}))), 1):
        spec = (C.StreamSpec(**m, **main), C.StreamSpec(**c, **ctx))
        cpu = C.ConjoinedVMAE(*spec, device='cpu')
        sd = weights.init_conjoined_state_dict(
            cpu, torch.Generator().manual_seed(i))
        model = C.ConjoinedVMAE(*spec, device=d)
        wrappers.append((model, sd, kw))
    raft = weights.init_raft(RAFT(iters=2, device='cpu'),
                             torch.Generator().manual_seed(3))
    if d != 'cpu':
        gpu = RAFT(iters=2, device=d)
        gpu.load_state_dict(raft.state_dict(), strict=True)
        raft = gpu
    out = []
    for model, sd, kw in wrappers:
        if 'main_input_kwargs' in kw:
            kw['main_input_kwargs']['flow_model'] = raft
        out.append(C.ConjoinedPredictorWrapper(
            model, params={k: v.to(d) for k, v in sd.items()},
            context_input='imu', **kw))
    return out, raft


@pytest.mark.parametrize('engine', ['fast', 'exact'])
def test_imu_generator_on_the_card_matches_the_cpu(dev, engine):
    """ImuConditionedFlowGenerator at the small configuration in f32 (TF32
    off), the static-scene IMU from flow2imu, from the same weights and
    draws on the card and on the CPU: videos and flows within 1e-3; on the
    card the path's kernels ran the counts the code gives, on the CPU
    none."""
    from counterfactualworldmodels_tpu_torch.pipelines.imu import (
        ImuConditionedFlowGenerator)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(4)
    x = rng.rand(1, 3, 64, 64).astype(np.float32)
    active = np.ones((1, 128, 4), dtype=bool)
    active[:, :64] = False
    for i in range(4):
        active[0, 64 + rng.choice(64, 2, replace=False), i] = False
    outs = {}
    for d in ('cpu', 'cuda'):
        (imu, f2i), raft = _small_imu(d)
        gen = _fixed_draws(ImuConditionedFlowGenerator(
            predictor=imu, head_motion_predictor=f2i, flow_model=raft,
            raft_iters=2, imagenet_normalize_inputs=True, engine=engine,
            device=d), 5)
        kernels.reset_launches()
        y, f = gen.predict_counterfactual_videos_and_flows(
            x, active, num_samples=4, sample_batch_size=2)
        outs[d] = (y.cpu(), f.cpu(), dict(kernels.LAUNCHES))
    (yc, fc, lc), (yg, fg, lg) = outs['cpu'], outs['cuda']
    assert max(_err(yc, yg), _err(fc, fg)) <= 1e-3
    assert not any(lc.values())
    # flow2imu once (K1 in its 8 blocks, RAFT-2 forward and backward), two
    # chunks: fast, the prefix once (4 main blocks) and K2 in both decoder
    # blocks per chunk; exact, the predictor's 8 blocks per chunk
    want = (dict(flash_attention=8 + 4, flash_attention_prefix=4,
                 window_lookup=4 + 4) if engine == 'fast' else
            dict(flash_attention=8 + 16, window_lookup=4 + 4))
    assert lg == dict({k: 0 for k in lg}, **want), lg
