"""The controls of the output checks, on the card at each cell's own size.

The control is the plain reference computed in float8 (the precision
below the bfloat16 the configuration states) in the program's place; for
the training cell also the reference taking the mean over half of each
batch. Each has to fail one of its cell's numbers on every seed. Run on a
card with

    python -m pytest -p no:cacheprovider -m cuda \
        cwm_bench/tests/test_cwmbench_control.py
"""
import pytest
import torch

from cwm_bench import harness

SEEDS = (4100000001, 4100000002, 4100000003)
CASES = [('cf-vitl4x4-s256', 'control'), ('train-vitl4x4-b8', 'control'),
         ('train-vitl4x4-b8', 'fault_half_batch')]


@pytest.mark.cuda
@pytest.mark.parametrize('cell,side', CASES,
                         ids=[f'{c}-{s}' for c, s in CASES])
def test_control_fails_the_check(cell, side):
    if not torch.cuda.is_available():
        pytest.skip('the control runs at the cell\'s own size on a card')
    c = harness.load_cell(cell)
    driver = harness.load_driver(c.spec['driver'])
    limits = c.spec['limits']
    for seed in SEEDS:
        got = getattr(driver, side)(c.config, c.spec['traffic'], seed,
                                    torch.device('cuda'))
        print(cell, side, seed, got)
        assert any(not got[k] <= limits[k] for k in limits), (seed, got)
