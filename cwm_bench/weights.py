"""Seeded weights in the reference layout, made on the device.

All of a model's weights come from one ``torch.randn`` over their total
size with a ``torch.Generator`` on the device, cut into the tensors and
scaled: matrices and convolution kernels lecun-normal (std 1/sqrt(fan_in)),
norm scales 1 + 0.1 n, biases and tokens 0.02 n, batch-norm means 0.1 n and
variances exp(0.1 n). Norms and biases are drawn rather than left at 1 and
0, so an output check sees a dropped bias or scale. The same seed gives the
same weights; each model draws from its own stream of the seed.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from cwm_bench.traffic.prompts import call_seed

Spec = List[Tuple[str, Tuple[int, ...], Callable]]


def lecun(fan_in: int):
    return lambda n: n / math.sqrt(fan_in)


def scale_(n):
    return 1.0 + 0.1 * n


def small(n):
    return 0.02 * n


def variance(n):
    return torch.exp(0.1 * n)


def draw(spec: Spec, seed: int, stream: int, device
         ) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} for (name, shape, transform) in ``spec``."""
    total = sum(math.prod(shape) for _, shape, _ in spec)
    g = torch.Generator(device=device)
    g.manual_seed(call_seed(seed, 0, stream))
    flat = torch.randn(total, generator=g, device=device)
    out, i = {}, 0
    for name, shape, fn in spec:
        k = math.prod(shape)
        out[name] = fn(flat[i:i + k].view(shape)).contiguous()
        i += k
    return out


def vmae_spec(v: Dict) -> Spec:
    """The VMAE's state dict in the reference layout (VideoMAE's names)."""
    e, cd = v['encoder_embed_dim'], v['decoder_embed_dim']
    p, c, pt = v['patch_size'], v['in_chans'], v['tubelet_size']
    spec: Spec = [('encoder.patch_embed.proj.weight', (e, c, pt, p, p),
                   lecun(c * pt * p * p)),
                  ('encoder.patch_embed.proj.bias', (e,), small)]

    def block(prefix, d):
        hid = int(d * v['mlp_ratio'])
        spec.extend([
            (f'{prefix}.norm1.weight', (d,), scale_),
            (f'{prefix}.norm1.bias', (d,), small),
            (f'{prefix}.attn.qkv.weight', (3 * d, d), lecun(d)),
            (f'{prefix}.attn.q_bias', (d,), small),
            (f'{prefix}.attn.v_bias', (d,), small),
            (f'{prefix}.attn.proj.weight', (d, d), lecun(d)),
            (f'{prefix}.attn.proj.bias', (d,), small),
            (f'{prefix}.norm2.weight', (d,), scale_),
            (f'{prefix}.norm2.bias', (d,), small),
            (f'{prefix}.mlp.fc1.weight', (hid, d), lecun(d)),
            (f'{prefix}.mlp.fc1.bias', (hid,), small),
            (f'{prefix}.mlp.fc2.weight', (d, hid), lecun(hid)),
            (f'{prefix}.mlp.fc2.bias', (d,), small)])

    for i in range(v['encoder_depth']):
        block(f'encoder.blocks.{i}', e)
    spec += [('encoder.norm.weight', (e,), scale_),
             ('encoder.norm.bias', (e,), small),
             ('encoder_to_decoder.weight', (cd, e), lecun(e)),
             ('mask_token', (1, 1, cd), small)]
    for i in range(v['decoder_depth']):
        block(f'decoder.blocks.{i}', cd)
    od = c * pt * p * p
    spec += [('decoder.norm.weight', (cd,), scale_),
             ('decoder.norm.bias', (cd,), small),
             ('decoder.head.weight', (od, cd), lecun(cd)),
             ('decoder.head.bias', (od,), small)]
    return spec


def vmae_state_dict(v: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return draw(vmae_spec(v), seed, 1, device)


def raft_state_dict(module: torch.nn.Module, seed: int, device
                    ) -> Dict[str, torch.Tensor]:
    """Seeded weights for every parameter and buffer of the reference RAFT
    ``module`` (reference/raft.py), in its state dict's layout: a tensor
    registered under two names (the residual blocks' norm3, also
    downsample.1) gets one value under both."""
    spec: Spec = []
    for name, t in list(module.named_parameters()) + list(
            module.named_buffers()):
        leaf = name.rsplit('.', 1)[-1]
        if leaf == 'num_batches_tracked':
            continue
        if t.dim() == 4:
            fn = lecun(t.shape[1] * t.shape[2] * t.shape[3])
        elif leaf == 'running_var':
            fn = variance
        elif leaf == 'weight':
            fn = scale_
        elif leaf == 'running_mean':
            fn = lambda n: 0.1 * n  # noqa: E731
        else:
            fn = small
        spec.append((name, tuple(t.shape), fn))
    values = draw(spec, seed, 2, device)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(
                module.named_buffers()):
            if name in values:
                t.copy_(values[name])
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def raft_config_state_dict(r: Dict, seed: int, device
                           ) -> Dict[str, torch.Tensor]:
    """Seeded weights of the RAFT that the configuration's ``raft`` group
    describes (reference/raft.py's layout)."""
    from cwm_bench.reference.raft import RAFT
    module = RAFT(r['corr_levels'], r['corr_radius'], r['iters'])
    return raft_state_dict(module.to(device), seed, device)
