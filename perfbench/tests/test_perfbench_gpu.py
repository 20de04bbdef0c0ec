"""The control on the card, at the cells' own sizes (one H100 holds each):
the plain reference in the program's place with its f32 products in TF32
has to come out not correct on every seed, while the program, on the same
seeds, comes out correct. Run on the card with
`python -m pytest -m gpu perfbench/tests/test_perfbench_gpu.py`."""
import pytest

from perfbench.harness import check, registry

SEEDS = (2147483999, 17, 4242)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control runs on a CUDA GPU")
    return torch


@pytest.mark.gpu
@pytest.mark.parametrize('name', [w['name'] for w in
                                  registry.load_benchmark()['workloads']])
def test_the_control_fails_and_the_program_passes(name, cuda):
    cell = registry.cell(name)
    cell.traffic['settle_rounds'] = 0    # after the checked steps
    driver = registry.driver(cell.traffic)
    for seed in SEEDS:
        out = driver.run(cell, seed, 3.0, False, device='cuda', control=True)
        ok, checks = check.judge(out['readings'], cell.limits)
        assert ok, (seed, checks)
        ok, checks = check.judge(out['control'], cell.limits)
        assert not ok, (seed, checks)
        del out
        cuda.cuda.empty_cache()
