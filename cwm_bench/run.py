"""One run of one benchmark cell, as a fresh process.

    python3 -m cwm_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is ``cwm_bench/workloads/<cell>.json``: its configuration
(``configs/<config>.json``), its driver (``drivers/<driver>.py``) and its
traffic parameters. A run loads the program with weights made from the
seed, warms up the cell's own shapes, measures for ``--seconds`` and then
judges what the timed calls returned against the plain reference under
``reference/``. With ``--trace 1`` it also times each layer alone and
profiles a short window, and reports the cell's per-layer metrics, each
read by ``metrics/<metric>.py``. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``);
the numbers that decide ``correct`` are also the last lines of standard
error, each beside its limit.

Without a CUDA device, or with fewer devices than the cell asks for, the
run exits with code 2 and prints no result. If JAX, flax, optax or the
JAX package is loaded once the window has closed, it exits with code 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from cwm_bench import harness  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    harness.set_cache_env()
    import torch
    cell = harness.load_cell(args.workload)
    need = int(cell.workload['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'cwm_bench: the cell {args.workload} needs {need} CUDA '
              f'device(s); this machine has {have}', file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device='cuda', t_start=T_START)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print('cwm_bench: the run loaded ' + ', '.join(found) +
              '; the benchmark measures the PyTorch port alone',
              file=sys.stderr)
        return 3
    for line in harness.check_lines(result['checks']):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
