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


def test_generator_entry_points_raise_without_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    from counterfactualworldmodels_tpu_torch.masking import generators
    from counterfactualworldmodels_tpu_torch.pipelines import (prediction,
                                                               segmentation)
    from counterfactualworldmodels_tpu_torch.utils import weights
    tm = tvmae.PretrainVisionTransformer(**SMALL_VMAE)
    sd = weights.init_vmae_state_dict(tm, torch.Generator().manual_seed(0))
    raft = traft.RAFT(iters=1, device='cpu')
    module = tvmae.PretrainVisionTransformerModule(tm, device='cpu')
    fp = tfv.stack_vmae_params(tm, sd, device='cpu')
    x = torch.zeros(1, 2, 3, 32, 32)
    masks = torch.zeros(1, tm.num_patches, 1, dtype=torch.bool)
    shifts = torch.ones(1, 1, 2, dtype=torch.long)
    exact = (module, raft, x, masks, masks, shifts, torch.Generator(),
             tm.num_patches, False, 1, True)
    multi = (tm, fp, raft, x[0:1], masks[..., 0], masks[..., 0], shifts[0],
             0, False, 1, True, False, False, torch.Generator(),
             tfv.make_prefix_cache(tm, fp, False, False, x[:, 0]))
    for call in (
            lambda **kw: segmentation.FlowGenerator(
                predictor=tm, params=sd, flow_model=raft, **kw),
            lambda **kw: prediction.PredictorBasedGenerator(
                predictor=tm, params=sd, **kw),
            lambda **kw: generators.RotatedTableEnergyMaskingGenerator(
                (2, 8, 8), 0.0, **kw),
            lambda **kw: segmentation.counterfactual_videos_and_flows(
                *exact, **kw),
            lambda **kw: (segmentation
                          .counterfactual_videos_and_flows_fast_multi(
                              *multi, n_vis=tm.num_patches, **kw))):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
        assert call(device='cpu') is not None


def test_new_modules_import_in_a_fresh_process_without_jax():
    """The port's modules import without JAX and without matplotlib (only
    the plotting calls import it)."""
    mods = ('ops.sampling', 'masking.mask_ops', 'masking.generators',
            'pipelines.perturbation', 'pipelines.filters',
            'pipelines.prediction', 'pipelines.segmentation',
            'models.fast_vmae', 'ops.coords', 'ops.flow_viz', 'vis_utils',
            'pipelines.movability', 'models.transformer',
            'models.preprocessor', 'models.conjoined',
            'models.fast_conjoined', 'pipelines.imu')
    code = ('import importlib, sys; '
            'pkg = "counterfactualworldmodels_tpu_torch."; '
            f'[importlib.import_module(pkg + m) for m in {mods!r}]; '
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith("jax.") or m == "flax" or m.startswith("flax.") or '
            'm == "counterfactualworldmodels_tpu" or '
            'm.startswith("counterfactualworldmodels_tpu.") or '
            'm == "matplotlib"]; '
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_imu_entry_points_raise_without_cuda_unless_cpu_is_asked():
    """The conjoined factories and modules, the flow preprocessor's default
    RAFT, the engine's weights and the IMU generators default to the card
    and raise without one; each runs with device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    from counterfactualworldmodels_tpu_torch.models import (
        conjoined, fast_conjoined, preprocessor)
    from counterfactualworldmodels_tpu_torch.pipelines import imu, movability
    from counterfactualworldmodels_tpu_torch.utils import weights
    for factory in (conjoined.imu400_base_4x4patch_2frames_1tube,
                    conjoined.imu400_8x8patch_2frames_1tube_flowbackrgb01):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            factory()
        assert factory(device='meta').main.num_patches > 0
    main = conjoined.StreamSpec(img_size=(32, 32), patch_size=(8, 8),
                                encoder_embed_dim=32, encoder_depth=2,
                                encoder_num_heads=2, decoder_embed_dim=16,
                                decoder_depth=1, decoder_num_heads=2,
                                padded=True, max_padding_tokens=4)
    ctx = conjoined.StreamSpec(is_imu=True, in_chans=6, sequence_length=32,
                               imu_tubelet=8, encoder_embed_dim=16,
                               encoder_depth=2, encoder_num_heads=2,
                               decoder_embed_dim=16, decoder_depth=1,
                               decoder_num_heads=2, concat_dummy_token=False,
                               padded=True, max_padding_tokens=4)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        conjoined.ConjoinedVMAE(main=main, context=ctx)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        preprocessor.get_preprocessor('flowback_rgb01')
    model = conjoined.ConjoinedVMAE(main=main, context=ctx, device='cpu')
    sd = weights.init_conjoined_state_dict(model,
                                           torch.Generator().manual_seed(0))
    wrapper = conjoined.ConjoinedPredictorWrapper(model, params=sd)
    assert fast_conjoined.cast_params(model, sd)['main_mask_token'].is_cpu
    raft = traft.RAFT(iters=1, device='cpu')
    for cls in (imu.ImuConditionedFlowGenerator,
                movability.ImuConditionedMovabilityPredictor):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            cls(predictor=wrapper, head_motion_predictor=wrapper,
                flow_model=raft)
        assert cls(predictor=wrapper, head_motion_predictor=wrapper,
                   flow_model=raft, device='cpu').device.type == 'cpu'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        imu.ImuGenerator(predictor=wrapper, flow_model=raft)
    assert imu.ImuGenerator(predictor=wrapper, flow_model=raft,
                            device='cpu').num_head_tokens == 4


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
