"""Port parity: the engine fidelity report (scripts/fidelity_report.py).

The helpers (pair statistics, end products, map agreement) against the JAX
script's own, loaded from its file, on seeded arrays within 1e-6. The
report's legs on the tests' small VMAE (32 px, 4x4 patches) and RAFT with
2 iterations, on the report's prompt policy, against the same calls
through the JAX package with JAX's rectangularizer draws injected: the
exact model and the engine at the pool-2 rung with the tanh gelu (the
engine at the exact rung is tests/test_torch_segmentation.py's). Videos
within 1e-4 and flows within 1e-3 px. ``main`` on the CPU: every key, no error recorded in place of a
result, and a failing leg raises (on the small models: the report takes
its image size from the model).
"""
import importlib.util
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from counterfactualworldmodels_tpu.models import fast_vmae as jfv
from counterfactualworldmodels_tpu.models import vmae as jvmae
from counterfactualworldmodels_tpu.models.raft import raft as jraft
from counterfactualworldmodels_tpu.pipelines import segmentation as jseg
from counterfactualworldmodels_tpu_torch.models import conjoined as tconj
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft
from counterfactualworldmodels_tpu_torch.scripts import fidelity_report as fr
from counterfactualworldmodels_tpu_torch.utils import weights

from torch_port_common import (IMG, SMALL_VMAE, assert_close, conj_specs,
                               jax_uniform_noise, t)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread for the port's CPU runs here: tier-1 shares the
    cores among six workers, where many small parallel ops stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jscript():
    spec = importlib.util.spec_from_file_location(
        'jax_fidelity_report', os.path.join(REPO, 'scripts',
                                            'fidelity_report.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_helpers_match_the_jax_script(jscript):
    rng = np.random.RandomState(0)
    ye, yx = rng.rand(2, 4, 2, 3, 16, 16).astype(np.float32)
    fe = rng.randn(4, 1, 2, 16, 16).astype(np.float32)
    fx = fe + 0.1 * rng.randn(*fe.shape).astype(np.float32)
    got, want = fr._pair_stats(ye, fe, yx, fx), jscript._pair_stats(
        ye, fe, yx, fx)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    for probe in ((3, 5), (10, 14)):
        for a, b in zip(fr._end_products(fx, probe),
                        jscript._end_products(fx, probe)):
            assert_close(a, b, 1e-6)
    seg, mov = fr._end_products(fe, (3, 5))
    seg2, mov2 = fr._end_products(fx, (3, 5))
    for a, b in ((seg, seg2), (mov, mov2)):
        got, want = fr._map_agreement(a, b), jscript._map_agreement(a, b)
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, k
    assert fr.parse_pools('2:1,2:2:tanh,,4') == [(2, 1, 'erf'),
                                                 (2, 2, 'tanh'), (4, 1, 'erf')]
    assert [fr.rung_key(*r) for r in ((2, 1, 'erf'), (4, 4, 'tanh'))] == [
        'pool2', 'pool4_suffix4_tanh']


@pytest.fixture(scope='module')
def legs():
    jm = jvmae.PretrainVisionTransformer(**SMALL_VMAE)
    params = jax.jit(jvmae.init_params, static_argnums=0)(
        jm, jax.random.PRNGKey(0))
    tm = tvmae.PretrainVisionTransformer(**SMALL_VMAE)
    jfp = jfv.stack_vmae_params(jm, params, dtype=jnp.float32)
    jr = jraft.RAFT(iters=2)
    rparams = jax.jit(jraft.init_raft_params, static_argnums=(0, 2))(
        jr, jax.random.PRNGKey(1), 32)
    tr = traft.RAFT(iters=2, device='cpu')
    tr.load_state_dict(weights.raft_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, rparams)), strict=True)
    sd = weights.vmae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), 3, tm.full_patch_size)
    return (jm, params, jfp, jr, rparams), fr.Legs(tm, sd, tr, torch.float32,
                                                   'cpu', log=[])


def test_legs_match_the_jax_package(legs):
    (jm, params, jfp, jr, rparams), tlegs = legs
    n, s = jm.num_patches, 3
    npf = n // 2
    rng = np.random.RandomState(5)
    x = np.repeat(rng.rand(1, 1, 3, 32, 32).astype(np.float32), 2, axis=1)
    passive, active, shifts, _ = fr.draw_prompts(rng, n, s)
    n_vis = npf + 33
    keys = jax.random.split(jax.random.PRNGKey(1), s).reshape(1, s, 2)
    noise = t(jax_uniform_noise(keys[0], npf))[None]
    jx, jp, ja, jsh = (jnp.asarray(v) for v in (x, passive, active, shifts))
    targs = (t(x), t(passive), t(active), t(shifts), noise, n_vis, 2)

    jy, jf, _ = jseg.counterfactual_videos_and_flows(
        jm, params, jr, rparams, jx, jp, ja, jsh, keys, n_vis, True, 2, True)
    ty, tf = tlegs.exact(*targs)
    assert_close(ty.numpy(), jy, 1e-4)
    assert_close(tf.numpy(), jf, 1e-3)

    pad = jfv.sfx_bucket(n_vis - npf, n - npf)
    for rung in ((2, 2, 'tanh'),):
        jy, jf, _ = jseg.counterfactual_videos_and_flows_fast(
            jm, jfp, jr, rparams, jx, jp, ja, jsh, keys, pad, True, 2, True,
            False, False, None, *rung, n_vis=n_vis)
        ty, tf = tlegs.fast(*targs, rung=rung)
        assert tuple(ty.shape) == jy.shape and tuple(tf.shape) == jf.shape
        assert_close(ty.numpy(), jy, 1e-4)
        assert_close(tf.numpy(), jf, 1e-3)
    assert [r['name'] for r in tlegs.log][-2:] == ['exact', 'fast']


def _tiny_conjoined(mode, dtype, device):
    """The tests' tiny conjoined model (64 px) in place of the report's
    configurations."""
    main, ctx, pairs = conj_specs(tconj, 'padded')
    return tconj.ConjoinedVMAE(main=main, context=ctx, dtype=dtype,
                               device=device, **pairs), IMG


def test_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    """main on the tests' small VMAE (the report takes its image size from
    the model) and tiny conjoined model."""
    monkeypatch.setattr(tvmae, 'base_8x8patch_2frames_1tube',
                        lambda **kw: tvmae.PretrainVisionTransformer(
                            **SMALL_VMAE, **kw))
    monkeypatch.setattr(fr, 'conjoined_model', _tiny_conjoined)
    out = tmp_path / 'fidelity.json'
    argv = ['--model', 'base', '--samples', '2', '--max-images', '1',
            '--raft-iters', '1', '--prefix-pools', '2:2:tanh',
            '--conjoined', 'small', '--out', str(out), '--device', 'cpu']
    report = fr.main(argv)
    assert json.loads(out.read_text()) == report
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == (
        report)
    for k in ('engine', 'weights', 'samples_per_image', 'model',
              'raft_iters', 'backend', 'per_image',
              'min_flow_corr', 'min_video_corr', 'min_segment_spearman',
              'min_movability_pearson', 'max_video_abs_err', 'conjoined'):
        assert k in report, k
    assert report['images'] == 'seeded random' and report['backend'] == 'cpu'
    row = report['per_image'][0]
    assert {'segment', 'movability', 'pool2_suffix2_tanh'} <= set(row)
    assert 'error' not in json.dumps(report)
    assert [r['name'] for r in report['legs']] == [
        'exact', 'fast', 'pool2_suffix2_tanh', 'conjoined exact',
        'conjoined fast']
    # the f32 decomposition runs only on a bf16 run
    assert 'bf16_vs_isolation_decomposition' not in report

    # a failing rung raises: nothing records the error and carries on
    with pytest.raises(ValueError, match='not divisible'):
        fr.main(['--model', 'base', '--samples', '2', '--max-images', '1',
                 '--raft-iters', '1', '--prefix-pools', '3:3', '--conjoined',
                 'off', '--out', str(out), '--device', 'cpu'])


def test_the_f32_legs_run_without_tf32():
    """The decomposition's f32 legs turn TF32 off for matmuls and cuDNN's
    convolutions and restore both flags after, also when a leg raises."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    before = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with pytest.raises(ValueError):
            with fr.strict_f32():
                assert [f.allow_tf32 for f in flags] == [False, False]
                raise ValueError('a failing leg')
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, before):
            f.allow_tf32 = v
