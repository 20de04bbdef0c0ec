"""The converter's CUDA graphs at playback (`gsavatar_torch/converter_graphs.py`),
their logic on the CPU: a stand-in graph captures by calling the converter
and keeping its outputs, and replays by calling it again and writing the
results into those outputs, as a CUDA graph writes its pool. Which of
eager, capture and replay each frame took is read from the tracer's
counters. The same on the card, with real graphs: tests/test_torch_gpu.py."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_dist_workers import STEP_TINY  # noqa: E402

from gsavatar_torch import tracing  # noqa: E402
from gsavatar_torch.camera.live import live_camera  # noqa: E402
from gsavatar_torch.config import load_config  # noqa: E402
from gsavatar_torch.converter_graphs import (  # noqa: E402
    MAX_GRAPHS, ConverterGraphs, tensors)
from gsavatar_torch.data import load_dataset  # noqa: E402
from gsavatar_torch.inference import InferenceScene, init_state  # noqa: E402
from gsavatar_torch.motion.series import MotionSeries  # noqa: E402
from gsavatar_torch.renderer import render  # noqa: E402
from gsavatar_torch.utils import ply as ply_io  # noqa: E402

# zju377_full's groups: every stage of the converter runs
RECIPE = ['pose_correction=direct', 'non_rigid=hashgrid',
          'rigid=skinning_field', 'texture=shallow_mlp']
ITERATION = 6000
PREFIX = 'converter/graph_'


class StandIn:
    """A graph on the CPU (see the module's docstring)."""

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        for kept, fresh in zip(tensors(self.out), tensors(self.fn())):
            kept.copy_(fresh)


class Raises(StandIn):
    def capture(self, fn):
        raise RuntimeError("operation not permitted when stream is capturing")


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.enable()          # no records, no counters
    tracing.disable()
    yield
    tracing.disable()


@pytest.fixture(scope='module')
def avatar():
    cfg = load_config(STEP_TINY + RECIPE)
    ds = load_dataset(cfg['dataset'], 'train')
    state = init_state(cfg, ds, seed=0, device='cpu')
    rng = np.random.default_rng(0)
    series = MotionSeries(
        {'pose': rng.normal(0.0, 0.2, (4, 72)).astype(np.float32)},
        ds.assets, device='cpu')
    return cfg, ds, state, series


def _scene(avatar, graph=StandIn):
    cfg, ds, state, series = avatar
    scene = InferenceScene(cfg, ds.metadata, ds.assets, state, device='cpu')
    if graph is not None:
        scene.converter_graphs.graph = graph
        scene.converter_graphs.engage = lambda gaussians: True
    cams = []
    for k in range(4):
        rots, jtrs, bt = series.camera_pose_fields(k, scene.metadata)
        a = 0.5 * k
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        cams.append(live_camera(R, np.array([0.0, 0.0, 2.5]), width=64,
                                height=64, rots=rots, Jtrs=jtrs,
                                bone_transforms=bt, device='cpu'))
    return scene, cams


def _frames(scene, frames):
    """Renders (camera, iteration) pairs, one tracer unit each; returns the
    packages and the graph counter each frame counted."""
    tracing.enable()
    pkgs = []
    for i, (cam, it) in enumerate(frames):
        with tracing.unit(i, 'frame'):
            pkgs.append(scene.render_frame(cam, it))
    tracing.disable()
    modes = [[] for _ in frames]
    for (u, name), v in sorted(tracing.counters().items(),
                               key=lambda kv: str(kv[0])):
        if name.startswith(PREFIX):
            modes[u] += [name[len(PREFIX):]] * int(v)
    return pkgs, [m[0] if len(m) == 1 else tuple(m) for m in modes]


@torch.inference_mode()
def _eager(scene, cam, it):
    return render(scene.converter, scene.view(), cam, it,
                  scene.raster_config, scene.background,
                  nr_cache=scene._nr_cache)


def _assert_same(pkg, ref):
    for a, b in ((pkg.render, ref.render),
                 (pkg.opacity_render, ref.opacity_render),
                 (pkg.colors, ref.colors),
                 (pkg.deformed_gaussians.get_xyz,
                  ref.deformed_gaussians.get_xyz),
                 (pkg.deformed_gaussians.rotation_precomp,
                  ref.deformed_gaussians.rotation_precomp)):
        assert torch.equal(a, b)
    assert pkg.loss_reg.keys() == ref.loss_reg.keys()
    for k in pkg.loss_reg:
        assert torch.equal(pkg.loss_reg[k], ref.loss_reg[k]), k


def test_a_key_captures_on_its_second_consecutive_frame(avatar):
    scene, cams = _scene(avatar)
    pkgs, modes = _frames(scene, [(c, ITERATION) for c in cams])
    assert modes == ['eager', 'capture', 'replay', 'replay']
    for pkg, cam in zip(pkgs, cams):
        _assert_same(pkg, _eager(scene, cam, ITERATION))


def test_alternating_keys_never_capture(avatar):
    scene, cams = _scene(avatar)
    its = [ITERATION, ITERATION + 1] * 3
    _, modes = _frames(scene, [(cams[0], it) for it in its])
    assert modes == ['eager'] * 6
    assert not scene.converter_graphs._graphs


def test_the_cap_evicts_the_oldest_graph(avatar):
    scene, cams = _scene(avatar)
    its = [ITERATION + k for k in range(MAX_GRAPHS + 1)]
    frames = [(cams[0], it) for it in its for _ in range(2)]
    _, modes = _frames(scene, frames)
    assert modes == ['eager', 'capture'] * (MAX_GRAPHS + 1)
    assert list(scene.converter_graphs._graphs) == [
        (0, 0, 0.0, it) for it in its[1:]]
    _, modes = _frames(scene, [(cams[1], its[1]), (cams[1], its[0])])
    assert modes == ['replay', 'eager']


def _drop(scene, how, tmp_path):
    if how == 'set_arena':
        scene._set_arena(scene.gauss_params, scene.gauss_aux)
    elif how == 'load_ply':
        path = str(tmp_path / 'arena.ply')
        ply_io.save_arena_ply(path, scene.gauss_params, scene.gauss_aux)
        scene.load_ply(path, capacity=1024)
    else:
        with torch.no_grad():
            next(scene.converter.parameters()).mul_(1.0)


@pytest.mark.parametrize('how', ['set_arena', 'load_ply', 'parameter'])
def test_a_new_arena_converter_or_parameter_drops_the_graphs(avatar, how,
                                                             tmp_path):
    scene, cams = _scene(avatar)
    _, modes = _frames(scene, [(c, ITERATION) for c in cams[:3]])
    assert modes == ['eager', 'capture', 'replay']
    _drop(scene, how, tmp_path)
    pkgs, modes = _frames(scene, [(c, ITERATION) for c in cams])
    assert modes == ['eager', 'capture', 'replay', 'replay']
    for pkg, cam in zip(pkgs, cams):
        _assert_same(pkg, _eager(scene, cam, ITERATION))


def test_a_kept_package_keeps_its_frame(avatar):
    """The replay writes each frame into the same outputs: the package of
    an earlier frame holds clones, not those outputs."""
    scene, cams = _scene(avatar)
    pkgs, modes = _frames(scene, [(c, ITERATION) for c in cams])
    assert modes == ['eager', 'capture', 'replay', 'replay']
    for pkg, cam in zip(pkgs, cams):
        _assert_same(pkg, _eager(scene, cam, ITERATION))
    graph = scene.converter_graphs._graphs[(0, 0, 0.0, ITERATION)]
    held = {t.data_ptr() for t in tensors(graph.out)}
    for pkg in pkgs[1:]:
        for t in tensors((pkg.deformed_gaussians, pkg.colors,
                          pkg.loss_reg)):
            assert t.data_ptr() not in held or t.data_ptr() in {
                a.data_ptr() for a in tensors(scene.view())}


def test_a_capture_that_raises_leaves_its_key_eager(avatar):
    scene, cams = _scene(avatar, graph=Raises)
    with pytest.warns(UserWarning, match='runs eagerly'):
        pkgs, modes = _frames(scene, [(c, ITERATION) for c in cams])
    assert modes == ['eager', ('eager', 'unsupported'), 'eager', 'eager']
    for pkg, cam in zip(pkgs, cams):
        _assert_same(pkg, _eager(scene, cam, ITERATION))


def test_cpu_render_frame_equals_render_to_the_bit(avatar):
    """On the CPU no graph engages: render_frame is `renderer.render`."""
    scene, cams = _scene(avatar, graph=None)
    pkgs, modes = _frames(scene, [(c, ITERATION) for c in cams])
    assert modes == [()] * 4
    assert not scene.converter_graphs._graphs
    for pkg, cam in zip(pkgs, cams):
        _assert_same(pkg, _eager(scene, cam, ITERATION))


def test_the_training_path_stays_eager(avatar):
    scene, cams = _scene(avatar)
    graphs = ConverterGraphs(scene.converter, graph=StandIn,
                             engage=lambda gaussians: True)
    gview = scene.view()
    tracing.enable()
    for _ in range(3):
        deformed, _, colors = graphs(gview, cams[0], ITERATION, train=True)
    tracing.disable()
    assert tracing.counters() == {} and not graphs._graphs
    want, _, want_colors = scene.converter(gview, cams[0], ITERATION)
    assert torch.equal(deformed.get_xyz, want.get_xyz)
    assert torch.equal(colors, want_colors)
