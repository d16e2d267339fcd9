"""Check that the GPU answers before a script commits to it.

Port of counterfactualworldmodels_tpu/utils/backend_guard.py with one
deliberate difference: the JAX guard re-runs the script on the CPU when the
accelerator does not answer, which would hide the device. This guard never
falls back. It probes ``torch.cuda.is_available()`` and one tiny launch in
a throwaway subprocess (a wedged driver hangs there, not in the caller),
and raises when the probe fails or times out, unless the caller asked for
the CPU.
"""
from __future__ import annotations

import subprocess
import sys

_PROBE = ('import torch, sys; '
          'ok = torch.cuda.is_available(); '
          'ok and float((torch.ones(8, device="cuda") * 2).sum()) == 16.0 '
          'or sys.exit(3)')


def ensure_live_backend(device='cuda', timeout_s: int = 240) -> None:
    """Raise RuntimeError unless a CUDA device answers one tiny launch
    within ``timeout_s`` seconds (in a subprocess). No-op when the caller
    asks for the CPU (``device='cpu'``)."""
    if str(device).split(':')[0] == 'cpu':
        return
    try:
        probe = subprocess.run([sys.executable, '-c', _PROBE],
                               capture_output=True, text=True,
                               timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f'the CUDA device did not answer a probe within '
                           f'{timeout_s} s') from e
    if probe.returncode != 0:
        raise RuntimeError(
            'no CUDA device answers (probe exit %d); pass device="cpu" to '
            'run the plain PyTorch path on the CPU\n%s'
            % (probe.returncode, probe.stderr[-2000:]))
