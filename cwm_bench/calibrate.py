"""Readings that the limits of the output check are set from.

    python3 -m cwm_bench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--seconds 3] [--control] [--out FILE]

For each seed, in one process: the program's numbers (a run of the cell
with a short window, judged as a benchmark run judges it) and, with
``--control``, the same numbers with the float8 reference in the
program's place (the driver's ``control``), and with ``--faults`` those of
each named fault planted in the reference put in the program's place (the
driver's ``fault_<name>``). One JSON line per reading, and
all of them in ``--out``. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from cwm_bench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--control', action='store_true')
    ap.add_argument('--program', type=int, default=1)
    ap.add_argument('--faults', default='',
                    help='comma-separated names of the driver\'s fault_<name>')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    harness.set_cache_env()
    import torch
    if not torch.cuda.is_available():
        print('cwm_bench.calibrate: no CUDA device', file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    driver = harness.load_driver(cell.spec['driver'])
    dev = torch.device('cuda')
    rows = []
    for seed in [int(s) for s in args.seeds.split(',')]:
        if args.program:
            t0 = time.perf_counter()
            run = driver.Run(cell.config, cell.spec['traffic'], seed, dev)
            run.warmup()
            run.window(args.seconds)
            t1 = time.perf_counter()
            got = run.check()
            rows.append({'side': 'program', 'seed': seed, 'checks': got,
                         'run_s': t1 - t0,
                         'check_s': time.perf_counter() - t1})
            print(json.dumps(rows[-1]), flush=True)
            del run
            torch.cuda.empty_cache()
        if args.control:
            t0 = time.perf_counter()
            got = driver.control(cell.config, cell.spec['traffic'], seed, dev)
            rows.append({'side': 'control', 'seed': seed, 'checks': got,
                         'check_s': time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
        for fault in [f for f in args.faults.split(',') if f]:
            t0 = time.perf_counter()
            got = getattr(driver, 'fault_' + fault)(
                cell.config, cell.spec['traffic'], seed, dev)
            rows.append({'side': 'fault_' + fault, 'seed': seed,
                         'checks': got, 'check_s': time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'workload': args.workload, 'rows': rows,
                       'device': torch.cuda.get_device_name(dev)}, f)
    return 0


if __name__ == '__main__':
    sys.exit(main())
