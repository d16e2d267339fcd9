"""The port's entry-point scripts stand alone: they import in a fresh
process without JAX, PIL or matplotlib (the card machine has neither of
the latter two), each raises without a GPU unless ``--device cpu`` is
passed, none holds a blanket exception handler that goes on, and the API
doc generator covers every one of them. (tests/test_torch_hygiene.py's
source walk, which finds no JAX import, already covers ``scripts/``.)"""
import ast
import os
import subprocess
import sys

import pytest
import torch

import counterfactualworldmodels_tpu_torch as port
from counterfactualworldmodels_tpu_torch.scripts import (
    bench, bench_attention, bench_conjoined, bench_loader, bench_sweep,
    bench_train, demo_counterfactuals, extract_structure, fidelity_report,
    gen_api_doc, latency_bench, loadgen, make_shards, serve_latency)

from test_torch_hygiene import _broad_handlers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ('scripts.extract_structure', 'scripts.make_shards',
           'scripts.fidelity_report', 'scripts.demo_counterfactuals',
           'scripts.gen_api_doc', 'scripts._io', 'utils.png',
           'utils.colormaps', 'serve', 'scripts._bench_common',
           'scripts.bench', 'scripts.bench_sweep', 'scripts.latency_bench',
           'scripts.serve_latency', 'scripts.loadgen',
           'scripts.bench_conjoined', 'scripts.bench_train',
           'scripts.bench_loader', 'scripts.bench_attention',
           'training.flops')
BENCHES = ('bench', 'bench_sweep', 'latency_bench', 'serve_latency',
           'loadgen', 'bench_conjoined', 'bench_train', 'bench_loader',
           'bench_attention')


def test_scripts_import_without_jax_pil_or_matplotlib():
    code = ('import importlib, sys; '
            'pkg = "counterfactualworldmodels_tpu_torch."; '
            f'[importlib.import_module(pkg + m) for m in {SCRIPTS!r}]; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "flax", "optax", "counterfactualworldmodels_tpu", '
            '"PIL", "matplotlib", "cv2", "scipy")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_blanket_exception_handler_in_the_scripts():
    """No fallback and no swallowed error: the fidelity report raises where
    the JAX script records an error and degrades, the shard writer's video
    reader catches only ImportError, the API doc generator lets a failing
    import raise, the measurement entry points keep no degrade chain and
    record no error."""
    root = os.path.dirname(port.__file__)
    broad = []
    for mod in SCRIPTS:
        path = os.path.join(root, *mod.split('.')) + '.py'
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                broad += [f'{mod}:{node.name}'
                          for _ in _broad_handlers(node)]
    assert broad == ['serve:do_POST']


@pytest.mark.parametrize('main, argv', [
    (extract_structure.main, ['--steps', '1', '--img-size', '64']),
    (make_shards.main, ['missing.npy', '--out-dir', 'unused']),
    (fidelity_report.main, ['--samples', '1', '--max-images', '1']),
    (demo_counterfactuals.main, ['--samples', '1']),
    (gen_api_doc.main, ['--out', 'unused.md']),
    (bench.main, []),
    (bench_sweep.main, ['--sizes', '2']),
    (latency_bench.main, ['--iters', '1']),
    (serve_latency.main, ['--max-prompt', '1']),
    (loadgen.main, ['--requests', '1']),
    (bench_conjoined.main, []),
    (bench_train.main, []),
    (bench_loader.main, ['--clips', '1']),
    (bench_attention.main, ['--s', '1']),
], ids=['extract_structure', 'make_shards', 'fidelity_report',
        'demo_counterfactuals', 'gen_api_doc', *BENCHES])
def test_scripts_raise_without_cuda_unless_cpu_is_asked(main, argv,
                                                         tmp_path,
                                                         monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        main(argv)
    assert os.listdir(tmp_path) == []


def test_api_doc_covers_every_script(tmp_path):
    out = gen_api_doc.main(['--out', str(tmp_path / 'api.md'),
                            '--device', 'cpu'])
    text = open(out).read()
    for mod in ('extract_structure', 'make_shards', 'fidelity_report',
                'demo_counterfactuals', 'gen_api_doc', '_bench_common',
                *BENCHES):
        assert f'## `counterfactualworldmodels_tpu_torch.scripts.{mod}`' in (
            text), mod
    assert ' at 0x' not in text
    assert '`write_png(' in text and '`imsave(' in text
