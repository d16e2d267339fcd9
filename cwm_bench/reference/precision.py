"""The arithmetic the reference runs in.

``F32`` is float32 with TF32 off (``f32_mode`` switches it off for the
card). ``BF16`` rounds every product's operands to bfloat16, the
precision the configurations state, and sums in float32: the output check
measures how far the flow moves under it. ``FP8`` is the control: the same reference with every product's
operands rounded to float8 e4m3, each tensor scaled by its largest
magnitude to the format's largest value (448), and the products summed in
float32. It is the next precision below the bfloat16 that the
configurations state."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def f32_mode():
    """TF32 off for matmuls and convolutions inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, back in float32. The
    gradient passes the rounding unchanged (straight through)."""
    x = x.float()
    xd = x.detach()
    amax = xd.abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    q = (xd / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - xd)


class F32:
    name = 'f32'

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        return x.float()

    @classmethod
    def matmul(cls, a, b):
        return torch.matmul(cls.q(a), cls.q(b))

    @classmethod
    def conv2d(cls, x, w, b, stride=1, padding=0):
        return F.conv2d(cls.q(x), cls.q(w), b, stride, padding)


class BF16(F32):
    name = 'bf16'

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).float()


class FP8(F32):
    name = 'fp8'

    @staticmethod
    def q(x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x)


PRECISIONS = {'f32': F32, 'bf16': BF16, 'fp8': FP8}
