"""Port: the multi-process layer (parallel/multihost.py, parallel/mesh.py)
and the trainers' --dp, on the CPU under gloo.

Single-process: initialize_distributed's environment rules (a no-op
without hints; a bad address raises, never a quiet single-process run),
process_local_batch_size, and a tp mesh's world size on one rank. Then one
spawn of two ranks (a FileStore under tmp_path, a join timeout) runs the
module's multi-process checks: the hybrid mesh, per-rank batches,
replicate, and ``train_vmae --dp`` / ``train_raft --dp`` for two steps
uninterrupted and for one step, a checkpoint and a resumed second, whose
loss and final weights must equal the uninterrupted run's bit for bit.
This module imports no JAX, so its ranks start quickly; test_torch_parallel
shares its spawn helper.
"""
import json
import multiprocessing
import os
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from counterfactualworldmodels_tpu_torch import parallel
from counterfactualworldmodels_tpu_torch.parallel import mesh as pmesh
from counterfactualworldmodels_tpu_torch.training import (train as TT,
                                                          train_raft,
                                                          train_vmae)
from counterfactualworldmodels_tpu_torch.utils import checkpoint as ck

WORLD = 2
JOIN_S = 300
HINTS = ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE',
         'MASTER_ADDR', 'MASTER_PORT')


@pytest.fixture(autouse=True, scope='module')
def two_threads():
    """Two intra-op threads for the module, restored after it: the suite
    runs several test processes at once, and a full-width torch thread
    pool on shared cores is many times slower than two threads (a CPU
    train_raft run: 72 s against 2.6 s under such load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def spawn_ranks(tmp, target, world=WORLD, join_s=JOIN_S):
    """Start ``world`` processes running ``target(rank, tmp)`` (a function
    of an importable module); returns a function that joins them within
    ``join_s`` seconds, fails with their tracebacks if one failed, and
    loads each rank's ``rank{r}.pt``."""
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=target, args=(r, tmp)) for r in range(world)]
    for p in procs:
        p.start()

    def join():
        for p in procs:
            p.join(join_s)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        errs = []
        for r in range(world):
            path = os.path.join(tmp, f'rank{r}.err')
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f.read())
        assert not alive, f'ranks did not finish in {join_s} s'
        assert all(p.exitcode == 0 for p in procs), '\n'.join(errs)
        return [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                           weights_only=False) for r in range(world)]
    return join


def rank_session(rank, tmp, checks):
    """Join the gloo group of the spawn (a FileStore in ``tmp``), run
    ``checks(rank, tmp) -> results``, save them as ``rank{r}.pt`` (or the
    traceback as ``rank{r}.err``)."""
    torch.set_num_threads(2)
    try:
        parallel.initialize_distributed(
            init_method='file://' + os.path.join(tmp, 'store'),
            world_size=WORLD, rank=rank, device='cpu', timeout_s=JOIN_S)
        results = checks(rank, tmp)
        torch.save(results, os.path.join(tmp, f'rank{rank}.pt'))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f'rank{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# single-process rules
# ---------------------------------------------------------------------------

def test_initialize_distributed_without_hints_is_a_no_op(monkeypatch):
    for k in HINTS:
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize_distributed(device='cpu') is False
    monkeypatch.setenv('WORLD_SIZE', '1')              # torchrun, one process
    assert parallel.initialize_distributed(device='cpu') is False
    assert not dist.is_initialized()


def test_initialize_distributed_raises_on_a_bad_address(monkeypatch):
    """A failed rendezvous raises; nothing carries on single-process."""
    for k in HINTS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('MASTER_ADDR', 'localhost')
    monkeypatch.setenv('MASTER_PORT', 'notaport')
    with pytest.raises(ValueError):
        parallel.initialize_distributed(device='cpu', timeout_s=5)
    monkeypatch.delenv('MASTER_PORT')
    with pytest.raises(ValueError, match='port number missing'):
        parallel.initialize_distributed(init_method='tcp://localhost',
                                        world_size=2, rank=0, device='cpu',
                                        timeout_s=5)
    assert not dist.is_initialized()


def test_process_local_batch_size_and_single_process_meshes():
    assert parallel.process_local_batch_size(32) == 32
    with pytest.raises(RuntimeError, match='initialize_distributed'):
        parallel.make_mesh({'dp': 1})
    with pytest.raises(RuntimeError, match='initialize_distributed'):
        parallel.make_hybrid_mesh({'dp': 1}, {'local': 1})


def test_tensor_parallelism_raises(tmp_path):
    """A tp mesh needs one process per card: on a group of one rank
    make_mesh({'dp': 1, 'tp': 2}) raises for the world size; a dp x tp
    mesh splits the batch over 'dp', and a mesh without 'dp' raises."""
    dist.init_process_group('gloo', init_method='file://' + str(
        tmp_path / 'store'), world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match='has 2 ranks; the process '
                                             'group has 1'):
            parallel.make_mesh({'dp': 1, 'tp': 2})
        mesh = parallel.make_mesh({'dp': 1, 'tp': 1})
        assert TT.data_parallel(mesh).axis == 'dp'
        with pytest.raises(ValueError, match="has no axis 'dp'"):
            TT.data_parallel(parallel.make_mesh({'tp': 1}))
    finally:
        dist.destroy_process_group()


def test_images_mode_says_when_pil_is_missing(monkeypatch, tmp_path):
    monkeypatch.setitem(__import__('sys').modules, 'PIL', None)
    with pytest.raises(SystemExit, match='needs PIL'):
        train_raft.main(['--images', str(tmp_path), '--small',
                         '--img-size', '64', '--steps', '1', '--device',
                         'cpu'])
    with pytest.raises(SystemExit, match='--synthetic, --shard PATH or'):
        train_raft.main(['--small', '--img-size', '64', '--device', 'cpu'])
    with pytest.raises(SystemExit, match='--targets or'):
        train_raft.main(['--mode', 'keypoint', '--synthetic', '--small',
                         '--img-size', '64', '--device', 'cpu'])


def test_train_raft_keypoint_on_targets_resumes(tmp_path):
    """train_raft --mode keypoint on an .npz of targets, one process: two
    steps, and one step, a checkpoint and a resumed second with the same
    loss."""
    rng = np.random.RandomState(0)
    path = str(tmp_path / 'maps.npz')
    np.savez(path, images=(rng.rand(4, 3, 64, 64) * 255).astype(np.float32),
             targets=rng.rand(4, 1, 64, 64).astype(np.float32))
    base = ['--mode', 'keypoint', '--targets', path, '--small', '--iters',
            '2', '--img-size', '64', '--batch-size', '2', '--warmup-steps',
            '1', '--device', 'cpu']
    full = train_raft.main(base + ['--steps', '2'])
    d = str(tmp_path / 'ck')
    train_raft.main(base + ['--steps', '1', '--checkpoint-dir', d])
    resumed = train_raft.main(base + ['--steps', '2', '--checkpoint-dir', d])
    assert [r['step'] for r in resumed] == [2]
    assert resumed[0]['loss'] == full[1]['loss']
    assert 'epe' not in full[0] and np.isfinite(full[0]['grad_norm'])


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

TRAINERS = {
    'train_vmae': (train_vmae.main, [
        '--synthetic', '--model', 'tiny', '--img-size', '16',
        '--patch-size', '8', '--batch-size', '4', '--warmup-steps', '0',
        '--lr', '1e-3', '--device', 'cpu']),
    'train_raft': (train_raft.main, [
        '--synthetic', '--small', '--iters', '2', '--img-size', '64',
        '--batch-size', '4', '--warmup-steps', '0', '--device', 'cpu']),
}


def _checks(rank, tmp):
    out = {'initialized': parallel.initialize_distributed(device='cpu'),
           'local_batch': parallel.process_local_batch_size(32)}
    try:
        parallel.process_local_batch_size(33)
    except ValueError as e:
        out['odd_batch'] = str(e)
    os.environ['LOCAL_WORLD_SIZE'] = str(WORLD)
    hybrid = parallel.make_hybrid_mesh({'dp': 1}, {'local': WORLD})
    out['hybrid'] = (hybrid.mesh_dim_names, tuple(hybrid.mesh.shape),
                     pmesh.axis_rank(hybrid, 'local'))
    try:
        parallel.make_hybrid_mesh({'dp': WORLD}, {'local': 1})
    except ValueError as e:
        out['hybrid_bad'] = str(e)
    mesh = parallel.make_mesh({'dp': WORLD})
    out['put'] = tuple(parallel.host_local_batch_to_global(
        mesh, 'dp', np.ones((2, 3), np.float32), 'cpu', 4).shape)
    try:
        parallel.host_local_batch_to_global(mesh, 'dp', np.ones((2, 3)),
                                            global_size=5)
    except ValueError as e:
        out['put_bad'] = str(e)
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(rank + 1.0)
    parallel.replicate(lin, mesh)
    out['replicated'] = lin.weight.detach().clone()
    for name, (main, argv) in TRAINERS.items():
        full, part = (os.path.join(tmp, f'{name}_{k}') for k in ('full',
                                                                 'part'))
        metrics = os.path.join(tmp, f'{name}.jsonl')
        out[name] = dict(
            full=main(argv + ['--steps', '2', '--dp', '0', '--checkpoint-dir',
                              full, '--metrics', metrics]),
            first=main(argv + ['--steps', '1', '--dp', '2',
                               '--checkpoint-dir', part]),
            resumed=main(argv + ['--steps', '2', '--dp', '2',
                                 '--checkpoint-dir', part]))
    return out


def _rank_main(rank, tmp):
    rank_session(rank, tmp, _checks)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp('ranks'))
    return tmp, spawn_ranks(tmp, _rank_main)()


def test_group_helpers_on_two_ranks(ranks):
    _, res = ranks
    for r, out in enumerate(res):
        assert out['initialized'] is True and out['local_batch'] == 16
        assert 'does not split over 2' in out['odd_batch']
        assert out['hybrid'] == (('dp', 'local'), (1, WORLD), r)
        assert 'a host runs 2' in out['hybrid_bad']
        assert out['put'] == (2, 3) and 'not the global batch of 5' in \
            out['put_bad']
        assert torch.equal(out['replicated'], torch.ones(2, 3))


@pytest.mark.parametrize('name', sorted(TRAINERS))
def test_trainer_dp_resumes_to_the_same_run(ranks, name):
    """--dp 0 (every process) and --dp 2, two steps (no warm-up: the
    first update moves the weights): rank 0 logs and saves; the resumed
    second step repeats the uninterrupted one's loss, and both runs' final
    checkpoints are equal bit for bit."""
    tmp, res = ranks
    for out in res:
        run = out[name]
        assert [r['step'] for r in run['full']] == [1, 2]
        assert [r['step'] for r in run['resumed']] == [2]
        assert run['resumed'][0]['loss'] == run['full'][1]['loss']
        assert run['full'][1]['loss'] != run['full'][0]['loss']
        assert all(np.isfinite(r['loss']) for r in run['full'])
    # both ranks log the same (averaged) metrics; rank 0 alone writes them
    for a, b in zip(res[0][name]['full'], res[1][name]['full']):
        assert a['loss'] == b['loss'] and a['grad_norm'] == b['grad_norm']
    with open(os.path.join(tmp, f'{name}.jsonl')) as f:
        assert [json.loads(ln)['step'] for ln in f] == [1, 2]
    saved = [ck.load_params(os.path.join(
        tmp, f'{name}_{k}', 'step_000000002', ck.STATE_FILE))
        for k in ('full', 'part')]
    assert saved[0]['step'] == saved[1]['step'] == 2
    for k, v in saved[0]['model'].items():
        assert torch.equal(v, saved[1]['model'][k]), k
