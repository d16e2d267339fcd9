"""Each driver runs a tiny cell on the CPU through the harness and gives
the contract's result; with the timed path broken underneath, the output
check comes out false; without a card, ``cwm_bench.run`` exits with an
error and prints no result."""
import json

import pytest
import torch

from cwm_bench import harness, run
from tiny import CF_TRAFFIC, TRAIN_TRAFFIC, tiny_cell

SEED = 2 ** 33 + 12345          # wider than 32 bits, as the driver's are
CASES = [('cf-vitl4x4-s256', CF_TRAFFIC), ('train-vitl4x4-b8', TRAIN_TRAFFIC)]


def _run(name, traffic, trace=False, seed=SEED):
    return harness.run_cell(tiny_cell(name, traffic), seed, 0.3, trace,
                            device='cpu')


@pytest.mark.parametrize('name,traffic', CASES, ids=[c for c, _ in CASES])
def test_tiny_run_gives_the_contract_line(name, traffic):
    result = _run(name, traffic)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == 'checks'
    assert {'correct', 'attempted', 'failed', 'metrics', 'device'} <= set(line)
    assert line['correct'] is True, line['checks']
    assert line['attempted'] > 0 and line['failed'] == 0
    cell = tiny_cell(name, traffic)
    assert set(line['metrics']) == {m['name'] for m in cell.end_to_end}
    for c in line['checks'].values():
        assert c['value'] <= c['limit']


@pytest.mark.parametrize('name,traffic', CASES, ids=[c for c, _ in CASES])
def test_tiny_traced_run_reads_its_metrics(name, traffic):
    result = _run(name, traffic, trace=True)
    assert result['correct'] is True
    assert {'busy_s', 'window_s'} <= set(result['device'])
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    cell = tiny_cell(name, traffic)
    per_layer = {m['name'] for m in cell.per_layer}
    # on the CPU no kernel runs: only what needs no device trace is read
    assert set(result['metrics']) <= per_layer
    assert result['metrics']


def test_same_seed_same_inputs():
    from cwm_bench.drivers import dispatch
    cell = tiny_cell('cf-vitl4x4-s256', CF_TRAFFIC)
    a = dispatch.Run(cell.config, cell.spec['traffic'], SEED,
                     torch.device('cpu'))
    b = dispatch.Run(cell.config, cell.spec['traffic'], SEED,
                     torch.device('cpu'))
    for pa, pb in zip(a.calls[:3], b.calls[:3]):
        assert torch.equal(pa.scene, pb.scene)
        assert torch.equal(pa.passive_mask, pb.passive_mask)


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc = run.main(['--workload', 'cf-vitl4x4-s256', '--seed', str(SEED),
                   '--seconds', '1', '--trace', '0'])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ''
    assert 'CUDA' in out.err


# -- faults planted in the program's timed path -----------------------------

def test_fault_flow_altered(monkeypatch):
    """A flow altered where RAFT produces it (one sample's, by 20%)."""
    from counterfactualworldmodels_tpu_torch.pipelines import segmentation
    real = segmentation.apply_raft_shared0

    def altered(*a, **k):
        flows = real(*a, **k).clone()
        flows[1] = flows[1] * 1.2
        return flows

    monkeypatch.setattr(segmentation, 'apply_raft_shared0', altered)
    result = _run('cf-vitl4x4-s256', dict(CF_TRAFFIC, check_rows=4))
    assert result['correct'] is False
    assert result['checks']['flow_gap_bf16x']['value'] > \
        result['checks']['flow_gap_bf16x']['limit']


def test_fault_prediction_altered(monkeypatch):
    """One predicted patch value altered where the engine produces it."""
    from counterfactualworldmodels_tpu_torch.models import fast_vmae
    from counterfactualworldmodels_tpu_torch.pipelines import segmentation
    real = fast_vmae._predict_frame1_core

    def altered(*a, **k):
        y = real(*a, **k).clone()
        y[0] = y[0] * 1.1
        return y

    monkeypatch.setattr(fast_vmae, '_predict_frame1_core', altered)
    monkeypatch.setattr(segmentation, '_predict_videos_core',
                        fast_vmae._predict_videos_core)
    result = _run('cf-vitl4x4-s256', dict(CF_TRAFFIC, check_rows=4))
    assert result['correct'] is False


def test_fault_step_leaves_state_unchanged(monkeypatch):
    from counterfactualworldmodels_tpu_torch.training import train as T
    monkeypatch.setattr(T.Optimizer, 'update',
                        lambda self, opt, params, step, gnorm=None:
                        torch.zeros(()))
    result = _run('train-vitl4x4-b8', TRAIN_TRAFFIC)
    assert result['correct'] is False


def test_fault_half_batch(monkeypatch):
    """The step takes the mean over the first half of the batch only."""
    from counterfactualworldmodels_tpu_torch.training import train as T
    real = T._on

    def half(device, x, mask):
        return real(device, x[:x.shape[0] // 2], mask[:mask.shape[0] // 2])

    monkeypatch.setattr(T, '_on', half)
    result = _run('train-vitl4x4-b8', dict(TRAIN_TRAFFIC, batch_size=4))
    assert result['correct'] is False


def test_profile_keeps_the_pass_after_the_profilers_warmup():
    from cwm_bench import tracing
    calls = []
    x = torch.randn(64, 64)

    def unit():
        calls.append(1)
        return x @ x

    prof = tracing.profile(unit, torch.device('cpu'), 2)
    assert len(calls) == tracing.PASSES * 2
    assert prof.units == 2 and prof.window_s > 0
