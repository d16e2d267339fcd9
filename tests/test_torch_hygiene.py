"""The PyTorch port stands alone: no module of it (nor chip_smoke.py)
imports JAX, flax or the JAX package; importing it loads no JAX; and with
no GPU its entry points raise unless the CPU is asked for."""
import ast
import os
import subprocess
import sys

import pytest
import torch

import counterfactualworldmodels_tpu_torch as port
from counterfactualworldmodels_tpu_torch import _device, kernels
from counterfactualworldmodels_tpu_torch.models import fast_vmae as tfv
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft

from torch_port_common import SMALL_VMAE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'counterfactualworldmodels_tpu')


def _forbidden(name: str) -> bool:
    # exact name or the name followed by '.': the port's own package name
    # starts with 'counterfactualworldmodels_tpu' and must not match
    return any(name == f or name.startswith(f + '.') for f in FORBIDDEN)


def _port_sources():
    root = os.path.dirname(port.__file__)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, 'chip_smoke.py')


def test_forbidden_name_matcher():
    assert _forbidden('jax') and _forbidden('jax.numpy')
    assert _forbidden('counterfactualworldmodels_tpu.models')
    assert not _forbidden('counterfactualworldmodels_tpu_torch')
    assert not _forbidden('counterfactualworldmodels_tpu_torch.ops')
    assert not _forbidden('jaxtyping')


def test_port_imports_no_jax_package():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            bad += [f'{path}: {n}' for n in names if _forbidden(n)]
    assert not bad, bad


def test_import_in_fresh_process_loads_no_jax():
    code = ('import sys, counterfactualworldmodels_tpu_torch; '
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith("jax.") or m == "flax" or m.startswith("flax.") or '
            'm == "counterfactualworldmodels_tpu" or '
            'm.startswith("counterfactualworldmodels_tpu.")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_raise_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        _device.resolve_device()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        traft.RAFT(iters=1)
    tm = tvmae.PretrainVisionTransformer(**SMALL_VMAE)
    from counterfactualworldmodels_tpu_torch.utils import weights
    sd = weights.init_vmae_state_dict(tm, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tfv.stack_vmae_params(tm, sd)
    assert tfv.stack_vmae_params(tm, sd, device='cpu').patch_kernel.is_cpu
    assert traft.RAFT(iters=1, device='cpu').fnet.conv1.weight.is_cpu


def test_training_entry_points_raise_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    from counterfactualworldmodels_tpu_torch.training import train, train_vmae
    tm = tvmae.PretrainVisionTransformer(**SMALL_VMAE)
    opt = train.make_optimizer()
    for call in (lambda: tvmae.PretrainVisionTransformerModule(tm),
                 lambda: tvmae.init_params(tm),
                 lambda: train.init_train_state(tm, opt),
                 lambda: train.make_train_step(tm, opt, 70),
                 lambda: train_vmae.main(['--synthetic', '--model', 'tiny',
                                          '--steps', '1'])):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
    module = tvmae.PretrainVisionTransformerModule(tm, device='cpu')
    assert module.mask_token.is_cpu
    assert callable(train.make_train_step(tm, opt, 70, device='cpu'))


def test_kernel_sources_and_counters():
    """Every kernel source the loader names is in the package, and each
    kernel wrapper has its launch counter."""
    for name in kernels.SOURCES:
        assert os.path.exists(os.path.join(kernels.CSRC_DIR, name + '.cu'))
    assert set(kernels.LAUNCHES) == {'flash_attention',
                                     'flash_attention_prefix',
                                     'flash_attention_lse',
                                     'flash_attention_bwd',
                                     'window_lookup'}


def test_library_path_covers_the_headers(tmp_path, monkeypatch):
    """A kernel's library name hashes its source, every csrc header and the
    flags: editing a header the source includes gives a new library, never
    the stale build."""
    monkeypatch.setattr(kernels, 'CSRC_DIR', str(tmp_path))
    (tmp_path / 'k.cu').write_text('#include "h.cuh"\n')
    (tmp_path / 'h.cuh').write_text('// v1\n')
    first = kernels.library_path('k')
    assert kernels.library_path('k') == first
    (tmp_path / 'h.cuh').write_text('// v2\n')
    second = kernels.library_path('k')
    assert second != first
    (tmp_path / 'k.cu').write_text('#include "h.cuh"\n// edited\n')
    assert kernels.library_path('k') not in (first, second)
    assert os.path.dirname(first) == kernels.BUILD_DIR
