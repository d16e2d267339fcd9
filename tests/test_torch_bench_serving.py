"""The serving probes of the port (``scripts/serve_latency.py`` and
``scripts/loadgen.py``) on the CPU at the JAX scripts' off-accelerator
defaults (the tiny model at 32 px, RAFT-1): one JSON line with every key of
the JAX script's record, and micro-batching that merges concurrent
requests."""
import json

import pytest
import torch

from counterfactualworldmodels_tpu_torch.scripts import loadgen, serve_latency


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread for the port's CPU runs here: tier-1 shares the
    cores among six workers, where parallel ops stall (the bench's RAFT at
    224 px took minutes with every core's threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_json_line(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{')]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_serve_latency_main_on_cpu(capsys, tmp_path):
    out = tmp_path / 'serve.json'
    rec = serve_latency.main(['--max-prompt', '5', '--num-samples', '2',
                              '--out', str(out), '--device', 'cpu'])
    assert _one_json_line(capsys) == json.loads(json.dumps(rec))
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    r = rec['serve_first_request_by_prompt_size']
    assert {'model', 'img_size', 'engine', 'num_samples', 'build_sec',
            'warmup_sec', 'warmup_programs',
            'first_request_sec_by_prompt_size', 'worst_first_request_sec',
            'target_met_lt_1s', 'note'} <= set(r)
    assert (r['model'], r['img_size'], r['raft_iters']) == ('tiny', 32, 1)
    assert sorted(r['first_request_sec_by_prompt_size']) == [1, 2, 3, 4, 5]
    assert r['worst_first_request_sec'] == max(
        r['first_request_sec_by_prompt_size'].values())
    assert r['target_met_lt_1s'] is None      # a statement about the card
    assert r['warmup_programs'] == 4          # predict + 3 prompt buckets


def test_loadgen_batches_concurrent_requests(capsys):
    rec = loadgen.main(['--clients', '4', '--requests', '8', '--samples',
                        '2', '--batch-window-ms', '200', '--device', 'cpu'])
    assert _one_json_line(capsys) == json.loads(json.dumps(rec))
    assert {'metric', 'value', 'unit', 'speedup_vs_serial', 'config',
            'trials'} <= set(rec)
    assert {'model', 'img_size', 'samples', 'requests', 'clients',
            'batch_window_ms', 'backend'} <= set(rec['config'])
    batched, serial = rec['trials']['batched'], rec['trials']['serial']
    for trial in (batched, serial):
        assert trial['requests_per_sec'] > 0 and trial['engine'] == 'fast'
        assert trial['sims_per_sec'] > trial['requests_per_sec']
    mb = batched['micro_batching']
    assert mb['requests_batched'] > 0
    assert 1 <= mb['dispatches'] < 8          # 8 requests, merged
    assert serial['micro_batching'] is None
    assert rec['value'] == batched['requests_per_sec']
