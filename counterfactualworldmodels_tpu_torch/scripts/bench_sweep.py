"""Sample-batch scaling sweep of the counterfactual benchmark.

Port of the JAX package's ``scripts/bench_sweep.py``: runs the port's
``scripts.bench`` at each per-scene sample count S of ``--sizes`` (one
process per size, ``CWM_BENCH_S`` set) and records the throughput, which
shows how the shared-prefix engine amortizes the scene-level work over S.
A size whose bench fails stops the sweep with the bench's error (the JAX
script skips it and goes on).

Prints one JSON object; ``--out`` also writes it to a file.

    python -m counterfactualworldmodels_tpu_torch.scripts.bench_sweep \\
        --sizes 8 16 32 64
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from .._device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--sizes', type=int, nargs='+',
                    default=[8, 16, 32, 64, 128])
    ap.add_argument('--out', default=None)
    ap.add_argument('--device', default='cuda',
                    help='passed on to the bench; "cpu" runs the plain '
                         'PyTorch path')
    return ap.parse_args(argv)


def run_bench(s: int, device: str) -> dict:
    """The bench's record at CWM_BENCH_S = s, from a fresh process."""
    env = dict(os.environ, CWM_BENCH_S=str(s))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env['PYTHONPATH'] = os.pathsep.join(
        [root] + [p for p in [env.get('PYTHONPATH')] if p])
    out = subprocess.run(
        [sys.executable, '-m',
         'counterfactualworldmodels_tpu_torch.scripts.bench',
         '--device', device], env=env, capture_output=True, text=True)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith('{')]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f'bench at S={s} failed (exit {out.returncode}):'
                           f'\n{out.stderr[-4000:]}')
    return json.loads(lines[-1])


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device)
    rows = []
    for s in args.sizes:
        rec = run_bench(s, args.device)
        rows.append({'s': s, 'sims_per_sec': rec['value'],
                     'mfu_executed': rec['mfu_executed'],
                     'stages': rec['stages'], 'config': rec['config']})
        print(f"S={s}: {rec['value']} sims/s "
              f"({rec['config']['engine']}, {rec['config']['backend']})",
              file=sys.stderr)
    report = {'workload': 'scripts.bench (shared-prefix engine, RAFT '
                          'probe; model and RAFT iterations per config)',
              'rows': rows}
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


if __name__ == '__main__':
    main()
