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


def test_no_attention_route_flags_or_switches():
    """ops.flash_attention alone chooses between a kernel and its plain
    version: no function of the port (nor of chip_smoke.py) takes a
    use_flash or two_source parameter, and none reads the switches
    CWM_FLASH_TWO_SOURCE or CWM_SFX_BUCKET."""
    flags = {'use_flash', 'two_source'}
    switches = {'CWM_FLASH_TWO_SOURCE', 'CWM_SFX_BUCKET'}
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.arg) and node.arg in flags:
                bad.append(f'{path}:{node.lineno}: parameter {node.arg}')
            elif (isinstance(node, ast.Constant)
                  and node.value in switches):
                bad.append(f'{path}:{node.lineno}: {node.value}')
    assert not bad, bad


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
             0, False, 1, True, torch.Generator(),
             tfv.make_prefix_cache(tm, fp, False, x[:, 0]))
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
            'models.fast_conjoined', 'pipelines.imu', 'ops.layer_norm')
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
    assert set(kernels.SOURCES) == {'attention', 'attention_bwd',
                                    'window_lookup', 'layer_norm',
                                    'qkv_heads'}
    assert set(kernels.LAUNCHES) == {'flash_attention',
                                     'flash_attention_prefix',
                                     'flash_attention_prefix_packed',
                                     'flash_attention_lse',
                                     'flash_attention_bwd',
                                     'window_lookup', 'add_layer_norm',
                                     'qkv_heads'}


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


SLICE8 = ('serve', 'interface', 'utils.batching', 'utils.profiling',
          'utils.cache', 'utils.backend_guard', 'ops.misc', 'ops.resize',
          'pipelines.patch_selector', 'data.utils')


def test_serving_and_analysis_modules_import_without_jax_pil_or_matplotlib():
    """The server, the interface and the analysis helpers import in a fresh
    process with no JAX, no PIL and no matplotlib (the card machine has
    neither of the latter: the server writes its PNGs itself, the
    interface draws through the axes it is given)."""
    code = ('import importlib, sys; '
            'pkg = "counterfactualworldmodels_tpu_torch."; '
            f'[importlib.import_module(pkg + m) for m in {SLICE8!r}]; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "flax", "counterfactualworldmodels_tpu", "PIL", '
            '"matplotlib", "serve")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _broad_handlers(fn):
    """`except Exception` / `except BaseException` / bare handlers directly
    in fn's body (not in functions nested in it) that do not re-raise."""
    stack, found = list(fn.body), []
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.ExceptHandler) and (
                node.type is None or (isinstance(node.type, ast.Name)
                                      and node.type.id in ('Exception',
                                                           'BaseException'))):
            if not any(isinstance(n, ast.Raise) and n.exc is None
                       for n in node.body):
                found.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return found


def test_no_blanket_exception_handler_in_the_serving_slice():
    """No fallback hides the device or a kernel: no engine, warmup route,
    kernel build or device probe sits in an `except Exception` that goes
    on. The one blanket handler that does not re-raise is the HTTP request
    boundary (do_POST), which answers 500 and keeps the server up (the
    batcher's hands a dispatch error to every member and re-raises)."""
    root = os.path.dirname(port.__file__)
    broad = []
    for mod in SLICE8:
        path = os.path.join(root, *mod.split('.')) + '.py'
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                broad += [f'{mod}:{node.name}'
                          for _ in _broad_handlers(node)]
    assert broad == ['serve:do_POST']


def test_serving_entry_points_raise_without_cuda_unless_cpu_is_asked():
    """build_generator / build_imu_generator, both services, the patch
    selector and the interface default to the card (or take their device
    from their generator) and raise without one; each runs on the CPU
    when asked."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    import argparse
    from counterfactualworldmodels_tpu_torch import interface, serve
    from counterfactualworldmodels_tpu_torch.pipelines import (
        imu, patch_selector, segmentation)
    args = argparse.Namespace(
        model='tiny', img_size=32, params=None, raft_params=None,
        flow2imu_params=None, raft_iters=1, seed=0, engine='fast',
        prefix_cache_size=2, movability_samples=2, movability_iters=1)
    for build in (serve.build_generator, serve.build_imu_generator):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build(args)
    g = serve.build_generator(args, device='cpu')
    assert isinstance(g, segmentation.FlowGenerator)
    assert g.device.type == 'cpu' and g.predictor.dtype == torch.float32
    gi = serve.build_imu_generator(args, device='cpu')
    assert isinstance(gi, imu.ImuConditionedFlowGenerator)
    assert gi.num_iters == 1 and gi.sample_batch_size == 2
    on_card = type('G', (), {'device': torch.device('cuda')})()
    for make in (lambda G: serve.CwmService(G, 32),
                 lambda G: serve.ImuCwmService(G, 32),
                 lambda G: patch_selector.IterativePatchSelector(G)):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            make(on_card)
    assert serve.CwmService(g, 32).device.type == 'cpu'
    assert serve.ImuCwmService(gi, 32).device.type == 'cpu'
    assert patch_selector.IterativePatchSelector(g).device.type == 'cpu'

    class Axes:
        figure = type('F', (), {'canvas': type('C', (), {
            'mpl_connect': staticmethod(lambda *a: 0)})()})()

        def text(self, *a, **k):
            return None

        def imshow(self, *a, **k):
            pass

    ui = interface.CounterfactualPredictionInterface(
        Axes(), g, x=torch.rand(1, 3, 48, 48), size=(32, 32))
    assert ui.device.type == 'cpu' and ui.x.shape[-2:] == (32, 32)
    assert ui._x.device.type == 'cpu'


SLICE9 = ('models.cmae', 'data.shards', 'utils.checkpoint', 'training.loop',
          'training.train', 'training.train_vmae', 'training.train_cmae',
          'training.train_conjoined')


def test_training_modules_import_without_jax():
    """The trainers, the shard loader and checkpointing import in a fresh
    process with no JAX and no matplotlib."""
    code = ('import importlib, sys; '
            'pkg = "counterfactualworldmodels_tpu_torch."; '
            f'[importlib.import_module(pkg + m) for m in {SLICE9!r}]; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "flax", "optax", "counterfactualworldmodels_tpu", '
            '"matplotlib")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_blanket_exception_handler_in_the_training_slice():
    """The loader choice has no fallback: no function of the trainers, the
    shard loader or checkpointing holds an `except Exception` (or bare
    `except`) that goes on."""
    root = os.path.dirname(port.__file__)
    broad = []
    for mod in SLICE9:
        path = os.path.join(root, *mod.split('.')) + '.py'
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                broad += [f'{mod}:{node.name}'
                          for _ in _broad_handlers(node)]
    assert broad == []


def test_native_loader_builds_from_the_port_copy():
    """The port compiles its own copy of the loader source into the
    ignored _build/ beside the kernels, never into the source tree."""
    from counterfactualworldmodels_tpu_torch.data import shards
    root = os.path.dirname(port.__file__)
    assert shards.SRC == os.path.join(root, 'data', 'native',
                                      'clip_loader.cpp')
    assert os.path.exists(shards.SRC)
    assert os.path.dirname(shards.native_library_path()) == os.path.join(
        root, '_build')
    with open(os.path.join(REPO, '.gitignore')) as f:
        assert 'counterfactualworldmodels_tpu_torch/_build/' in f.read()


def test_cmae_and_conjoined_trainers_raise_without_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    from counterfactualworldmodels_tpu_torch.models import cmae
    from counterfactualworldmodels_tpu_torch.training import (
        train_cmae, train_conjoined)
    kw = dict(image_size=(32, 32), patch_size=(8, 8), encoder_embed_dim=32,
              encoder_depth=1, encoder_num_heads=2, decoder_embed_dim=16,
              decoder_depth=1, decoder_num_heads=2)
    for call in (lambda: cmae.ChannelMae(**kw),
                 lambda: cmae.SoftChannelMae(**kw),
                 lambda: cmae.SoftInputChannelMae(**kw),
                 lambda: cmae.ChannelMaeEncoder(),
                 lambda: cmae.ChannelMaeDecoder(),
                 lambda: train_cmae.main(['--synthetic', '--model', 'tiny',
                                          '--steps', '1']),
                 lambda: train_conjoined.main(['--synthetic', '--steps',
                                               '1'])):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            call()
    assert cmae.ChannelMae(**kw, device='cpu').mask_token.is_cpu


SLICE10 = ('models.raft.corr', 'models.raft.raft', 'training.raft',
           'training.train_raft', 'training.loop', 'training.train',
           'parallel', 'parallel.mesh', 'parallel.multihost',
           'parallel.inference', 'parallel.covariance')


def test_raft_training_and_parallel_modules_import_without_jax():
    """RAFT training and the parallel package import in a fresh process
    with no JAX and no matplotlib."""
    code = ('import importlib, sys; '
            'pkg = "counterfactualworldmodels_tpu_torch."; '
            f'[importlib.import_module(pkg + m) for m in {SLICE10!r}]; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "flax", "optax", "counterfactualworldmodels_tpu", '
            '"matplotlib")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_blanket_exception_handler_in_raft_training_and_parallel():
    """No function of RAFT training or the parallel package goes on after
    an `except Exception`; parallel/multihost.py, whose JAX counterpart
    degrades to one process when the rendezvous fails, holds no handler
    at all: initialize_distributed raises."""
    root = os.path.dirname(port.__file__)
    broad = []
    for mod in SLICE10:
        path = os.path.join(root, *mod.split('.'))
        path = (os.path.join(path, '__init__.py') if os.path.isdir(path)
                else path + '.py')
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                broad += [f'{mod}:{node.name}'
                          for _ in _broad_handlers(node)]
    assert broad == []
    with open(os.path.join(root, 'parallel', 'multihost.py')) as f:
        tree = ast.parse(f.read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_raft_trainer_raises_without_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    from counterfactualworldmodels_tpu_torch.training import train_raft
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_raft.main(['--synthetic', '--steps', '1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_raft.main(['--mode', 'keypoint', '--synthetic', '--teacher',
                         'movability', '--steps', '1'])
