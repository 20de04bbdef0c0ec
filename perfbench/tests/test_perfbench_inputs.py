"""The seeded inputs repeat exactly, and differ between seeds."""
import numpy as np
import torch

from perfbench.drivers.train import frame_order
from perfbench.harness import inputs
from perfbench.harness.registry import cell

BIG = 2 ** 31 + 12345


def test_motion_repeats_and_depends_on_the_seed():
    traffic = cell('zju377_full.serve').traffic
    a, b = inputs.motion(traffic, BIG), inputs.motion(traffic, BIG)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a['pose'].shape == (traffic['motion_frames'], 72)
    assert not np.array_equal(a['pose'], inputs.motion(traffic, 7)['pose'])
    lo, hi = traffic['amplitude']
    assert np.abs(a['pose']).max() <= hi
    assert not a['pose'][:, :3].any() and not a['pose'][:, 66:].any()


def test_frame_order_pops_every_frame_once_a_round():
    order = frame_order(10, 35, BIG)
    assert order == frame_order(10, 35, BIG)
    for r in range(3):
        assert sorted(order[10 * r:10 * r + 10]) == list(range(10))
    assert order != frame_order(10, 35, BIG + 1)


def test_derived_seeds_fit_63_bits_and_differ_by_stream():
    s = {inputs.derived_seed(BIG, k) for k in range(5)}
    assert len(s) == 5 and all(0 <= v < 2 ** 63 for v in s)


def test_weights_repeat_and_stay_in_bounds():
    from perfbench.tests.tiny import tiny_cell
    cfg = tiny_cell('zju377_full.train').config['config']
    a = inputs.make_weights(cfg, BIG, 'cpu')
    b = inputs.make_weights(cfg, BIG, 'cpu')
    c = inputs.make_weights(cfg, BIG + 1, 'cpu')
    for k in a.trained:
        assert torch.equal(a.conv[k], b.conv[k])
    assert any(not torch.equal(a.conv[k], c.conv[k]) for k in a.trained)
    for f in a.arena:
        assert torch.equal(a.arena[f], b.arena[f])
    n = int(a.alive.sum())
    assert n == cfg['dataset']['n_points']
    assert float(a.arena['scaling'][:n].max()) <= np.log(inputs.MAX_SCALE)
