"""Port parity: clip shards, their loaders and IMU sidecars
(data/shards.py) against the JAX package's, byte for byte; checkpoints
(utils/checkpoint.py); and the three trainers' entry points on the CPU
(synthetic data and a shard), with a resume that repeats the uninterrupted
run's losses exactly."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from counterfactualworldmodels_tpu.data import shards as jshards
from counterfactualworldmodels_tpu_torch.data import shards
from counterfactualworldmodels_tpu_torch.training import (
    loop, train as TT, train_cmae, train_conjoined, train_vmae)
from counterfactualworldmodels_tpu_torch.utils import checkpoint as ck


def _clips(n=6, t=2, h=20, w=24, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, t, h, w, c),
                                               dtype=np.uint8)


@pytest.fixture
def shard(tmp_path):
    path = str(tmp_path / 'a.shard')
    jshards.write_shard(path, _clips())
    return path


def test_shards_and_sidecars_round_trip_between_the_packages(tmp_path):
    clips = _clips()
    imu = np.random.RandomState(1).randn(6, 6, 40).astype(np.float32)
    a, b = str(tmp_path / 'jax.shard'), str(tmp_path / 'port.shard')
    jshards.write_shard(a, clips)
    jshards.write_imu_sidecar(a, imu)
    shards.write_shard(b, clips)
    shards.write_imu_sidecar(b, imu)
    for ext in ('', '.imu'):
        with open(a + ext, 'rb') as fa, open(b + ext, 'rb') as fb:
            assert fa.read() == fb.read()
    assert shards.read_shard_header(a) == jshards.read_shard_header(b)
    np.testing.assert_array_equal(shards.read_imu_sidecar(a),
                                  jshards.read_imu_sidecar(b))
    assert shards.read_imu_sidecar(str(tmp_path / 'none')) is None
    shards.write_imu_sidecar(a, imu[:4])
    with pytest.raises(ValueError, match='4 rows for a shard of 6'):
        shards.read_imu_sidecar(a)
    for bad in (clips[..., :1].repeat(5, -1), clips[:0],
                clips.astype(np.float32)):
        with pytest.raises(ValueError):
            shards.write_shard(str(tmp_path / 'bad'), bad)


@pytest.mark.parametrize('out_dtype,crop,hflip,shuffle', [
    ('f32', None, False, True), ('u8', (16, 16), True, True),
    ('f32', (12, 20), True, False)])
def test_loaders_match_the_jax_loaders(shard, out_dtype, crop, hflip,
                                       shuffle):
    """The Python loaders on the same seed give equal batches and
    last_indices, and so do the native loaders (the port's with two
    workers: it hands batches out in index order); a loader started at
    batch k gives the batches from k on."""
    kw = dict(batch_size=4, crop_size=crop, seed=3, hflip=hflip,
              shuffle=shuffle, out_dtype=out_dtype)
    pairs = [(jshards.PythonClipLoader(shard, **kw),
              shards.PythonClipLoader(shard, **kw))]
    if jshards.build_native() is not None:
        assert shards.build_native() is not None
        pairs.append((jshards.NativeClipLoader(shard, num_threads=1, **kw),
                      shards.NativeClipLoader(shard, num_threads=2, **kw)))
    for ref, got in pairs:
        batches = []
        for _ in range(4):
            r, g = ref.next_batch(), got.next_batch()
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(got.last_indices, ref.last_indices)
            batches.append((g.copy(), got.last_indices.copy()))
        late = type(got)(shard, start_batch=2, **kw)
        for g, ids in batches[2:]:
            np.testing.assert_array_equal(late.next_batch(), g)
            np.testing.assert_array_equal(late.last_indices, ids)
        got.close()
        late.close()


def test_native_zero_copy_and_the_python_loader_on_a_port_shard(tmp_path):
    path = str(tmp_path / 'p.shard')
    shards.write_shard(path, _clips(seed=2))
    if shards.build_native() is None:
        pytest.skip('no C++ compiler: the native loader cannot be built')
    kw = dict(batch_size=3, crop_size=(16, 16), seed=1, out_dtype='u8')
    copy = shards.NativeClipLoader(path, **kw)
    view = shards.NativeClipLoader(path, zero_copy=True, **kw)
    py = jshards.PythonClipLoader(path, **kw)
    for _ in range(3):
        np.testing.assert_array_equal(view.next_batch(), copy.next_batch())
        assert py.next_batch().shape == copy.batch_shape
    view.close()
    with pytest.raises(StopIteration):
        view.next_batch()
    assert list(view) == []


def test_loader_choice_has_no_blanket_fallback(shard, monkeypatch, capsys):
    """The Python loader only when there is no compiler (and says so); a
    native loader that fails raises."""
    monkeypatch.setattr(shards, 'build_native', lambda: None)
    ld = shards.open_loader(shard, batch_size=2, num_threads=2)
    assert isinstance(ld, shards.PythonClipLoader)
    assert 'no C++ compiler' in capsys.readouterr().out
    monkeypatch.undo()
    if shards.build_native() is None:
        pytest.skip('no C++ compiler: the native loader cannot be built')
    assert isinstance(shards.open_loader(shard, batch_size=2),
                      shards.NativeClipLoader)
    with pytest.raises(RuntimeError, match='failed to open shard'):
        shards.open_loader(shard + '.missing', batch_size=2)


def test_build_native_reports_a_failing_compiler(tmp_path, monkeypatch):
    bad = tmp_path / 'bad.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(shards, 'SRC', str(bad))
    monkeypatch.setattr(shards, 'BUILD_DIR', str(tmp_path / 'build'))
    if not (os.environ.get('CXX') or shutil.which('g++')):
        assert shards.build_native() is None
        return
    with pytest.raises(RuntimeError, match='did not build'):
        shards.build_native()
    assert shards.native_library_path().startswith(str(tmp_path / 'build'))


def _state(mu=None):
    from counterfactualworldmodels_tpu_torch.models import vmae
    cfg = vmae.PretrainVisionTransformer(
        img_size=(16, 16), patch_size=(8, 8), encoder_embed_dim=16,
        encoder_depth=1, encoder_num_heads=1, decoder_embed_dim=16,
        decoder_depth=1, decoder_num_heads=1, num_frames=2)
    opt = TT.make_optimizer(mu_dtype=mu, warmup_steps=1, total_steps=5)
    return cfg, opt, TT.init_train_state(cfg, opt, seed=0, device='cpu')


@pytest.mark.parametrize('mu', [None, torch.bfloat16])
def test_checkpoint_manager_saves_keeps_and_restores(tmp_path, mu):
    cfg, opt, state = _state(mu)
    step = TT.make_train_step(cfg, opt, 6, remat=False, device='cpu')
    x = torch.rand(2, 2, 3, 16, 16)
    mask = TT.make_batch_masks(torch.Generator().manual_seed(0), cfg, 2,
                               0.5)[0]
    mgr = ck.CheckpointManager(str(tmp_path / 'ck'), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest(state) is None
    for _ in range(3):
        state, _ = step(state, x, mask)
        mgr.save(state.step, state)
    os.makedirs(tmp_path / 'ck' / 'step_000000009')       # no state file
    os.makedirs(tmp_path / 'ck' / 'step_x')
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    _, _, fresh = _state(mu)
    restored = mgr.restore_latest(fresh)
    assert restored.step == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    want, got = state.opt_state.state_dict(), restored.opt_state.state_dict()
    for pid, st in want['state'].items():
        for k, v in st.items():
            g = got['state'][pid][k]
            if isinstance(v, torch.Tensor):
                assert g.dtype == v.dtype and torch.equal(g, v), k
            else:
                assert g == v
    if mu is not None:
        assert all(s['exp_avg'].dtype == torch.bfloat16
                   for s in restored.opt_state.state.values())
    path = str(tmp_path / 'params.pt')
    ck.save_params(path, state.model.state_dict())
    assert set(ck.load_params(path)) == set(state.model.state_dict())
    keep1 = ck.CheckpointManager(str(tmp_path / 'k1'), max_to_keep=0)
    keep1.save(1, state)
    keep1.save(2, state)
    assert keep1.all_steps() == [2]


def _losses(capsys):
    return {r['step']: r['loss'] for r in map(
        json.loads, (ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith('{')))}


TINY = {
    'vmae': (train_vmae.main, ['--model', 'tiny', '--img-size', '16',
                               '--patch-size', '8']),
    'cmae': (train_cmae.main, ['--model', 'tiny', '--img-size', '16',
                               '--patch-size', '8']),
    'conjoined': (train_conjoined.main, ['--img-size', '16']),
}


@pytest.mark.parametrize('name', sorted(TINY))
def test_trainers_on_the_cpu_resume_to_the_same_losses(name, tmp_path,
                                                       capsys):
    """Each trainer on synthetic data, then on a shard with an IMU
    sidecar: two steps uninterrupted, and one step, a checkpoint and a
    resumed second step; the resumed step's loss equals the
    uninterrupted one's."""
    main, argv = TINY[name]
    base = argv + ['--device', 'cpu', '--batch-size', '2', '--warmup-steps',
                   '1']
    metrics = str(tmp_path / 'm.jsonl')
    records = main(base + ['--synthetic', '--steps', '2', '--metrics',
                           metrics])
    assert [r['step'] for r in records] == [1, 2]
    assert all(np.isfinite(r['loss']) and r['grad_norm'] > 0
               for r in records)
    with open(metrics) as f:
        assert [json.loads(ln)['step'] for ln in f] == [1, 2]
    path = str(tmp_path / 'c.shard')
    shards.write_shard(path, _clips(n=5, h=24, w=24, seed=4))
    shards.write_imu_sidecar(path, np.random.RandomState(5).randn(
        5, 6, 400).astype(np.float32))
    capsys.readouterr()
    for data in (['--synthetic'], ['--shard', path]):
        full = main(base + data + ['--steps', '2'])
        d = str(tmp_path / ('ck' + data[-1][-3:]))
        main(base + data + ['--steps', '1', '--checkpoint-dir', d])
        out = capsys.readouterr().out
        if data[0] == '--shard':
            assert 'loader=' in out
        resumed = main(base + data + ['--steps', '2', '--checkpoint-dir', d])
        assert 'resumed from step 1' in capsys.readouterr().out
        assert [r['step'] for r in resumed] == [2]
        assert resumed[0]['loss'] == full[1]['loss'], data
        assert ck.CheckpointManager(d).all_steps() == [1, 2]


def test_trainers_refuse_what_is_not_ported(shard, tmp_path):
    for main, argv in TINY.values():
        # --dp runs one process per card: one process cannot be two ranks
        with pytest.raises(SystemExit, match='torchrun --nproc_per_node=2'):
            main(argv + ['--synthetic', '--device', 'cpu', '--dp', '2'])
        # so does --tp: two processes, one per card
        with pytest.raises(SystemExit, match='torchrun --nproc_per_node=2'):
            main(argv + ['--synthetic', '--device', 'cpu', '--tp', '2'])
        with pytest.raises(SystemExit, match='--shard PATH or --synthetic'):
            main(argv + ['--device', 'cpu'])
    with pytest.raises(SystemExit, match='imu400 requires --img-size 224'):
        train_conjoined.main(['--model', 'imu400', '--img-size', '112',
                              '--synthetic', '--device', 'cpu'])
    jshards.write_imu_sidecar(shard, np.zeros((6, 6, 48), np.float32))
    with pytest.raises(SystemExit, match='sidecar length 48'):
        train_conjoined.main(['--img-size', '16', '--shard', shard,
                              '--device', 'cpu', '--steps', '1',
                              '--batch-size', '2'])


def test_step_generators_depend_on_seed_and_step_only():
    draw = [torch.rand(4, generator=loop.step_generator(
        torch.device('cpu'), seed, step)) for seed, step in
            ((0, 3), (0, 3), (0, 4), (1, 3))]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert not torch.equal(draw[0], draw[3])


def test_profile_window_writes_a_trace(tmp_path):
    """--profile-dir traces steps 4-6 (after three warm-up steps) into a
    Chrome trace."""
    main, argv = TINY['vmae']
    trace_dir = tmp_path / 'trace'
    main(argv + ['--synthetic', '--device', 'cpu', '--batch-size', '2',
                 '--steps', '7', '--profile-dir', str(trace_dir)])
    traces = list(trace_dir.glob('trace-*.json'))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
