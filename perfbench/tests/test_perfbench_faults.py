"""The check that decides `correct`, driven through a whole run of each
cell at a tiny size on the CPU (the harness's look for a chip skipped;
the program takes its plain paths, so a sound run reads 0): sound runs
pass, and each fault the cell can have makes `correct` false. The faults:
a training step that returns its state unchanged, an answer altered
where it is produced (the render off by 0.5 at one pixel), and a densify
round that does nothing or prunes nothing; neighbours left stale after
the round show in the `knn_gap` reading. The cells
train and serve one frame at a time on one chip, so they have no batch
to halve and no exchange between chips to leave out."""
import pytest

from perfbench.harness import check
from perfbench.tests.tiny import run_tiny

CELLS = ['zju377_full.train', 'zju377_full.serve',
         'ps_female3_rigid.serve']


def judged(name):
    cell, out = run_tiny(name)
    return check.judge(out['readings'], cell.limits)


@pytest.mark.parametrize('name', CELLS)
def test_a_sound_run_is_correct(name):
    ok, checks = judged(name)
    assert ok, checks


@pytest.mark.parametrize('name', CELLS)
def test_an_altered_render_is_not(name, monkeypatch):
    from perfbench import control
    from gsavatar_torch import inference, train
    monkeypatch.setattr(train, 'render', train.render)
    monkeypatch.setattr(inference, 'render', inference.render)
    control.plant_pixel_fault()
    ok, checks = judged(name)
    assert not ok, checks


@pytest.mark.parametrize('name', [c for c in CELLS if c.endswith('train')])
def test_a_step_that_leaves_its_state_unchanged_is_not(name, monkeypatch):
    from gsavatar_torch import train
    from gsavatar_torch.scene import ConverterOptimizer

    def no_update(params, grads, state, lrs, alive, apply=True):
        return params.map(lambda x: x.clone()), state

    def no_step(self, params, grads, state, frozen_grads=None):
        return state

    monkeypatch.setattr(train, 'adam_step', no_update)
    monkeypatch.setattr(ConverterOptimizer, 'step', no_step)
    ok, checks = judged(name)
    assert not ok, checks
    # the leaves at or above the median leaf's norm read 1 each
    assert checks['median_change_gap']['value'] > 0.5


def _no_round(params, aux, adam, eps1, eps2, **kwargs):
    import torch
    zero = torch.zeros((), dtype=torch.long)
    return params, aux, adam, {'n_cloned': zero, 'n_split': zero,
                               'n_dropped': zero, 'n_pruned': zero,
                               'n_alive': aux.alive.sum()}


def _no_prune(real):
    def densify(*args, **kwargs):
        return real(*args, **dict(kwargs, min_opacity=0.0,
                                  use_screen_size_prune=False))
    return densify


@pytest.mark.parametrize('fault', ['no_round', 'no_prune'])
@pytest.mark.parametrize('name', [c for c in CELLS if c.endswith('train')])
def test_a_densify_round_that_skips_its_work_is_not(name, fault,
                                                     monkeypatch):
    from gsavatar_torch import train
    monkeypatch.setattr(train, 'densify_and_prune', _no_round
                        if fault == 'no_round'
                        else _no_prune(train.densify_and_prune))
    ok, checks = judged(name)
    assert not ok, checks
    assert checks['alive_gap']['value'] > checks['alive_gap']['limit']


@pytest.mark.parametrize('name', [c for c in CELLS if c.endswith('train')])
def test_neighbours_left_stale_after_a_round_read_a_knn_gap(name,
                                                            monkeypatch):
    # read, not compared (PERF.md section 2): sound runs and the control
    # read 0, so no limit stands between them
    from gsavatar_torch import train
    assert run_tiny(name)[1]['readings']['knn_gap'] == 0.0
    monkeypatch.setattr(train, 'refresh_knn', lambda state, bucket: state)
    assert run_tiny(name)[1]['readings']['knn_gap'] > 0.5
