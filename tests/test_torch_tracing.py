"""The port's tracer (`gsavatar_torch/tracing.py`): off it records nothing
and changes no result; on, its spans nest with their parent and self time,
carry their unit's id (also those autograd's thread opens in a custom
backward), `device_read` counts each host read of the hot path once, and
every span's start and end match the host event the same span leaves in a
`torch.profiler` trace."""
import gc
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_dist_workers import STEP_TINY  # noqa: E402

from gsavatar_torch import tracing, train  # noqa: E402
from gsavatar_torch.config import load_config  # noqa: E402
from gsavatar_torch.inference import InferenceScene, init_state  # noqa: E402
from gsavatar_torch.motion.series import MotionSeries  # noqa: E402
from gsavatar_torch.scene import Scene  # noqa: E402

ITERATION = 1000
CLOCK_US = 20.0
# the host reads of one training step (the pair count, the perceptual
# crop's corner, the largest rect side, `host_metrics`) and of one pose
# step (bone transforms, vertices, joints)
STEP_READS = {('pairs.py', 'build_pairs'), ('losses.py', 'foreground_crop'),
              ('train.py', 'loss_fn'), ('train.py', 'host_metrics')}
POSE_READS = 3


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.enable()          # no records, no counters
    tracing.disable()
    yield
    tracing.disable()


def _scene():
    cfg = load_config(STEP_TINY)
    return Scene(cfg, seed=0, device='cpu')


def _step(scene):
    """One training step from the scene's first state, on its own draws;
    returns the metrics, on the host, and the state."""
    state = scene.init_state()
    weights = dict(train.loss_weights(scene.cfg, ITERATION),
                   _in_densify_window=1.0)
    draws = train.draw(scene, torch.Generator().manual_seed(5))
    bucket = scene.bucket_for(int(state.gauss_aux.alive.sum()))
    state, metrics = train.make_train_step(scene)(
        state, scene.device_camera(0, 'train'), ITERATION, weights, 1e-4,
        bucket=bucket, draws=draws)
    return train.host_metrics(metrics), state


def _render():
    cfg = load_config(STEP_TINY)
    from gsavatar_torch.data import load_dataset
    ds = load_dataset(cfg['dataset'], 'train')
    scene = InferenceScene(cfg, ds.metadata, ds.assets,
                           init_state(cfg, ds, seed=0, device='cpu'),
                           device='cpu')
    series = MotionSeries({'pose': np.full((2, 72), 0.1, np.float32)},
                          ds.assets, device='cpu')
    return scene, series, ds[0]


def test_off_records_nothing_and_costs_a_shared_no_op():
    tracing.enable()
    tracing.disable()
    assert tracing.span('render/converter') is tracing._NULL
    assert tracing.unit(3, 'train/step') is tracing._NULL
    x = torch.arange(4.0)
    with tracing.unit(3, 'train/step'), tracing.span('render/converter'):
        tracing.count('sync/reads')
        assert tracing.device_read(x) is x     # `x.cpu()` of a CPU tensor
    assert tracing.records() == [] and tracing.counters() == {}


def test_off_and_on_give_bit_equal_renders_and_steps():
    out = {}
    for on in (False, True):
        if on:
            tracing.enable()
        scene, series, cam = _render()
        pkg = scene.render_frame(cam, ITERATION)
        fields = series.camera_pose_fields(1, scene.metadata)
        metrics, state = _step(_scene())
        tracing.disable()
        out[on] = (pkg.render, pkg.opacity_render, fields, metrics,
                   state.gauss_params.xyz, state.gauss_adam.v.opacity,
                   [p.detach().clone() for p in state.conv_params.values()])
    assert tracing.records()
    off, on = out[False], out[True]
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    for a, b in zip(off[2], on[2]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert off[3] == on[3]
    assert torch.equal(off[4], on[4]) and torch.equal(off[5], on[5])
    assert all(torch.equal(a, b) for a, b in zip(off[6], on[6]))


def test_spans_nest_with_parent_and_self_time(monkeypatch):
    clock = iter(range(0, 10 ** 6, 1000))      # each reading 1 us later
    monkeypatch.setattr(tracing, '_now', lambda: next(clock))
    tracing.enable()
    with tracing.span('a'):                   # 0 ... 7000
        with tracing.span('b'):               # 1000 ... 4000
            with tracing.span('c'):           # 2000 ... 3000
                pass
        with tracing.span('b'):               # 5000 ... 6000
            pass
    recs = {(r.name, r.start_ns): r for r in tracing.records()}
    a, b0, c = recs[('a', 0)], recs[('b', 1000)], recs[('c', 2000)]
    assert a.parent is None and b0.parent == a.id and c.parent == b0.id
    assert recs[('b', 5000)].parent == a.id
    s = tracing.summary()
    assert s['a'] == {'total_ms': 7e-3, 'self_ms': 3e-3, 'calls': 1}
    assert s['b'] == {'total_ms': 4e-3, 'self_ms': 3e-3, 'calls': 2}
    assert s['c'] == {'total_ms': 1e-3, 'self_ms': 1e-3, 'calls': 1}
    tracing.enable()
    assert tracing.records() == []


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2 * x

    @staticmethod
    def backward(ctx, g):
        with tracing.span('backward/twice'):
            return 2 * g


def test_units_carry_their_id_into_other_threads_and_backward():
    tracing.enable()
    seen = {}

    def worker(k):
        with tracing.span('worker'):
            tracing.count('n', 2.0)
        seen[k] = threading.get_ident()

    for k in (5, 6):
        with tracing.unit(k, 'train/step'):
            x = torch.ones(3, requires_grad=True)
            with tracing.span('train/backward'):
                torch.autograd.grad(_Twice.apply(x).sum(), x)
            t = threading.Thread(target=worker, args=(k,))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            tracing.count('n')
    with tracing.span('outside'):
        tracing.count('n')
    recs = tracing.records()
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
    roots = {r.unit: r for r in by_name['train/step']}
    assert sorted(roots) == [5, 6]
    for r in by_name['worker'] + by_name['train/backward'] + \
            by_name['backward/twice']:
        assert r.unit in (5, 6)
    # each worker's record carries its own thread (the OS may or may not
    # hand the second worker the first one's ident)
    for r in by_name['worker']:
        assert r.parent is None and r.thread == seen[r.unit]
    for r in by_name['train/backward']:
        assert r.parent == roots[r.unit].id
    assert [r.unit for r in by_name['backward/twice']] == [5, 6]
    assert by_name['outside'][0].unit is None
    assert tracing.counters() == {(5, 'n'): 3.0, (6, 'n'): 3.0,
                                  (None, 'n'): 1.0}


# the stage spans inside the converter's, by the recipe's non-rigid field
# and texture: (name, parent) once each in one frame
STAGE_SPANS = {
    ('mlp', 'mlp'): [('non_rigid/pose_code', 'converter/non_rigid'),
                     ('non_rigid/mlp', 'converter/non_rigid'),
                     ('texture/inputs', 'converter/texture'),
                     ('texture/mlp', 'converter/texture')],
    ('hashgrid', 'shallow_mlp'): [
        ('non_rigid/pose_code', 'converter/non_rigid'),
        ('texture/inputs', 'converter/texture'),
        ('texture/mlp', 'converter/texture')],
    ('hannw_mlp', 'sh'): [('non_rigid/pose_code', 'converter/non_rigid'),
                          ('non_rigid/mlp', 'converter/non_rigid')],
}


@pytest.mark.parametrize('groups', sorted(STAGE_SPANS),
                         ids=lambda g: '-'.join(g))
def test_stage_spans_nest_in_the_converters_spans(groups):
    cfg = load_config(STEP_TINY + [f'non_rigid={groups[0]}',
                                   f'texture={groups[1]}'])
    from gsavatar_torch.data import load_dataset
    ds = load_dataset(cfg['dataset'], 'train')
    scene = InferenceScene(cfg, ds.metadata, ds.assets,
                           init_state(cfg, ds, seed=0, device='cpu'),
                           device='cpu')
    tracing.enable()
    scene.render_frame(ds[0], ITERATION)
    tracing.disable()
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    stages = sorted((r.name, by_id[r.parent].name) for r in recs
                    if r.name.startswith(('non_rigid/', 'texture/')))
    assert stages == sorted(STAGE_SPANS[groups])


def test_device_read_counts_each_hot_path_read_once(monkeypatch):
    sites = []
    plain = tracing.device_read

    def where(x):
        f = sys._getframe(1)
        sites.append((Path(f.f_code.co_filename).name, f.f_code.co_name))
        return plain(x)

    monkeypatch.setattr(tracing, 'device_read', where)
    scene, series, cam = _render()
    step_scene = _scene()
    step_scene.device_camera(0, 'train')    # renders its ground truth
    sites.clear()
    tracing.enable()
    with tracing.unit(0, 'frame'):
        series.camera_pose_fields(0, scene.metadata)
        scene.render_frame(cam, ITERATION)
    frame_sites = list(sites)
    sites.clear()
    with tracing.unit(1, 'train/step'):
        _step(step_scene)
    assert frame_sites == [('series.py', 'parse')] * POSE_READS + [
        ('pairs.py', 'build_pairs')]
    assert sorted(sites) == sorted(STEP_READS)
    c = tracing.counters()
    assert c[(0, 'sync/reads')] == POSE_READS + 1
    assert c[(1, 'sync/reads')] == len(STEP_READS)
    assert c[(0, 'sync/wait_ms')] >= 0 and c[(1, 'sync/wait_ms')] >= 0
    reads = [r for r in tracing.records() if r.name == 'sync/read']
    assert [r.unit for r in reads] == [0] * (POSE_READS + 1) + [1] * len(
        STEP_READS)


def _twins(prof, recs):
    """Each record beside the profiler's host event of the same name and
    occurrence, both as (start, end) in us on the profiler's timeline."""
    origin = tracing.profiler_origin_ns(prof)
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    for v in events.values():
        v.sort(key=lambda e: e.time_range.start)
    seen = {}
    for r in sorted(recs, key=lambda r: r.start_ns):
        k = seen.get(r.name, 0)
        seen[r.name] = k + 1
        e = events[r.name][k]
        yield ((r.start_ns - origin) / 1e3, (r.end_ns - origin) / 1e3), \
            (e.time_range.start, e.time_range.end)


def _clock_gaps() -> list:
    """The gap of each span of a fixed loop to its profiler twin, the larger
    of its start's and its end's, in the order the spans open."""
    x = torch.randn(64, 64)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the profiler's first event of a thread sets it up, hundreds of
        # us: not a span
        with record_function('warm'):
            pass
        for i in range(20):
            with tracing.unit(i, 'unit'):
                with tracing.span('outer'):
                    for _ in range(3):
                        with tracing.span('inner'):
                            x = torch.tanh(x * 1.5)
                    tracing.device_read(x.sum())
    tracing.disable()
    recs = tracing.records()
    assert len(recs) == 20 * 6
    return [max(abs(a - b) for a, b in zip(mine, theirs))
            for mine, theirs in _twins(prof, recs)]


def test_spans_match_the_profilers_host_events():
    """One offset, the profiler's trace start, puts every span within
    CLOCK_US of its twin at both ends. A host that preempts the process
    between a span's stamp and its `record_function` stretches that one
    gap in that one run, so the loop runs five times, with the collector
    off, and each span counts its least gap: a clock that disagrees does
    so in every run."""
    gc.disable()
    try:
        runs = [_clock_gaps() for _ in range(5)]
    finally:
        gc.enable()
    least = [min(g) for g in zip(*runs)]
    assert max(least) <= CLOCK_US, sorted(least)[-5:]


def test_off_under_a_profiler_spans_are_its_record_functions():
    scene, series, cam = _render()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        series.camera_pose_fields(0, scene.metadata)
        scene.render_frame(cam, ITERATION)
    names = [e.name for e in prof.events()]
    for n in ('motion/pose', 'render/converter', 'converter/pose_correction',
              'converter/non_rigid', 'converter/rigid', 'converter/texture',
              'rasterize/project', 'rasterize/pairs', 'rasterize/composite',
              'rasterize/untile'):
        assert names.count(n) == 1, n
    assert names.count('sync/read') == POSE_READS + 1
    assert tracing.records() == []


def test_trace_window_turns_the_tracer_on_for_its_window(tmp_path):
    w = train.TraceWindow(str(tmp_path), 2, 4, 'cpu')
    for it in range(1, 6):
        w.at(it)
        with tracing.unit(it, 'train/step'):
            assert tracing.enabled() == (2 <= it < 4)
    assert sorted(r.unit for r in tracing.records()) == [2, 3]
    assert (tmp_path / 'spans_2_4.json').exists()
    tracing.enable()                  # an operator's tracer stays on
    w = train.TraceWindow(str(tmp_path), 1, 2, 'cpu')
    w.at(1)
    w.at(2)
    assert tracing.enabled()
