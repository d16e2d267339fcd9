"""Shared helpers of the measurement entry points.

Port of the JAX package's ``scripts/_bench_common.py``: the small conjoined
model, the demo image and the demo prompt policy live here once, so that
``bench``, ``bench_conjoined`` and ``latency_bench`` measure the same
shapes. Beside them: the timing windows, the percentiles, the H100 peak
that MFU is taken against and the sample mesh of a ``torchrun`` launch.

The JAX prompt policy splits ``jax.random`` keys for the rectangularizer;
the port takes those draws as an input (``demo_noise``).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

# NVIDIA H100 SXM, dense bf16 on the tensor cores (data sheet): the peak
# every port MFU divides by
H100_PEAK_FLOPS = 989e12
H100_PEAK_NAME = 'H100 SXM dense bf16, 989 TFLOP/s'


def small_conjoined_model(dtype=torch.float32, attn_impl='dense',
                          device='cuda'):
    """The small IMU-conditioned conjoined configuration (the JAX
    package's, for runs on the CPU), built with the port's
    ``models.conjoined``. Returns (model, hw)."""
    from ..models import conjoined as conj
    ctx = conj.StreamSpec(
        is_imu=True, in_chans=6, sequence_length=400, imu_tubelet=16,
        encoder_embed_dim=64, encoder_depth=2, encoder_num_heads=4,
        decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=4,
        decoder_num_classes=96, mlp_ratio=2.0, concat_dummy_token=False,
        padded=True, max_padding_tokens=25)
    main = conj.StreamSpec(
        img_size=(112, 112), patch_size=(8, 8), in_chans=3, num_frames=2,
        encoder_embed_dim=96, encoder_depth=2, encoder_num_heads=4,
        decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4,
        mlp_ratio=2.0, padded=True, max_padding_tokens=64)
    model = conj.ConjoinedVMAE(
        main=main, context=ctx, conjoin_encoder_layers=((0, 0), (1, 1)),
        conjoin_decoder_layers=((0, 0),), dtype=dtype, attn_impl=attn_impl,
        device=device)
    return model, 112


def demo_static_movie(hw: int, rng: np.random.RandomState, b: int = 1,
                      image: Optional[str] = None) -> Tuple[np.ndarray, str]:
    """([B, 2, 3, hw, hw] float32 static 2-frame movie, its source): the
    image at ``image`` (``.npy``, or PNG / JPEG with PIL) in both frames,
    else a seeded random movie drawn from ``rng`` (the JAX package's
    stand-in when the reference demo image is absent)."""
    if image:
        from ._io import read_image
        frame = read_image(image, hw).transpose(2, 0, 1)
        movie = np.broadcast_to(frame, (b, 2, 3, hw, hw)).copy()
        return movie.astype(np.float32), image
    return rng.rand(b, 2, 3, hw, hw).astype(np.float32), 'seeded-random'


def demo_prompts(rng: np.random.RandomState, n: int, s: int, b: int = 1):
    """The benches' demo prompt policy: frame 0 visible; 32 visible
    patches and 1 active patch per sample in frame 1; shifts in [-3, 3]
    patches. Draws from ``rng`` exactly as the JAX package's does, so the
    same RandomState gives the same prompts. Returns (passive, active,
    shifts, n_vis): masks bool [B, N, S] (True = masked), shifts int64
    [B, S, 2]."""
    npf = n // 2
    p = np.ones((b, n, s), dtype=bool)
    p[:, :npf] = False
    a = np.ones((b, n, s), dtype=bool)
    a[:, :npf] = False
    for i in range(s):
        p[0, npf + rng.choice(npf, 32, replace=False), i] = False
        a[0, npf + rng.randint(npf), i] = False
    shifts = rng.randint(-3, 4, size=(b, s, 2)).astype(np.int64)
    return p, a, shifts, npf + 32 + 1


def demo_noise(s: int, n1: int, seed: int = 2) -> np.ndarray:
    """The rectangularizer's draws for S prompts, float32 [S, n1] in
    [0, 0.999), from their own seed (the JAX policy's PRNGKey(2))."""
    return (np.random.RandomState(seed).rand(s, n1) * 0.999).astype(
        np.float32)


def as_tensors(device: torch.device, *arrays) -> List[torch.Tensor]:
    """numpy arrays (copied: some are read-only views) as tensors on
    ``device``."""
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


def windows(fn: Callable[[], torch.Tensor], n_windows: int, per_window: int
            ) -> List[float]:
    """Seconds per call of ``fn`` in each of ``n_windows`` windows: each
    window enqueues ``per_window`` calls, adds their device scalars and
    ends in one host fetch (``.item()``) of the sum, which waits for the
    device. The caller warms ``fn`` first."""
    out = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        acc = fn()
        for _ in range(per_window - 1):
            acc = acc + fn()
        acc.item()
        out.append((time.perf_counter() - t0) / per_window)
    return out


def stage_ms(call: Callable[[], object], iters: int) -> float:
    """ms per call of one stage (the best of 2 windows of ``iters`` calls
    after a warm one), each call reduced to the summed |first output
    tensor| under no_grad."""
    def fn():
        with torch.no_grad():
            out = call()
        while not isinstance(out, torch.Tensor):
            out = out[0]
        return out.abs().float().sum()
    fn().item()
    return round(min(windows(fn, 2, iters)) * 1e3, 2)


def percentiles(lats_ms: List[float]) -> dict:
    """p50 / p90 / p99 (the JAX script's nearest-rank rule) and the
    chronological samples, rounded to 0.01 ms."""
    s = sorted(lats_ms)

    def pct(p):
        return round(s[min(len(s) - 1, int(p / 100 * len(s)))], 2)
    return {'p50_ms': pct(50), 'p90_ms': pct(90), 'p99_ms': pct(99),
            'lats_ms': [round(v, 2) for v in lats_ms]}


def device_record(device: torch.device) -> dict:
    """Where a run ran: the backend and, on the card, its name."""
    rec = {'backend': device.type}
    if device.type == 'cuda':
        rec['device_name'] = torch.cuda.get_device_name(device)
    return rec


def sample_mesh(device: torch.device):
    """(mesh, world size, rank) of a ``torchrun`` launch with WORLD_SIZE > 1
    (the process group comes up here; NCCL on cards, gloo on the CPU), or
    (None, 1, 0) for one process."""
    from ..parallel import initialize_distributed
    if not initialize_distributed(device=device):
        return None, 1, 0
    import torch.distributed as dist
    from ..parallel.mesh import sample_parallel_mesh
    world = dist.get_world_size()
    if world == 1:
        return None, 1, 0
    return sample_parallel_mesh(world), world, dist.get_rank()
