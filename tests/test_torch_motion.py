"""The port's motion series (gsavatar_torch/motion/series.py) against the
JAX package's, on seeded CLIFF-style arrays and an npz file: `parse`
(verts, joints, bone transforms and the parameters) and
`camera_pose_fields` (rots, normalised joints, bone transforms) in the
default mode, with the root orientation and the translation overridden,
and in accumulate mode; `export`'s keys and values. Tolerances: the LBS
products (verts, joints, bone transforms) and the camera fields to 1e-5
absolute, the parameters equal. Also: the OpenCV wrappers of
`motion/streams.py` raise an ImportError that names what needs OpenCV when
it is missing."""
import sys

import numpy as np
import pytest

from torch_parity import motion_arrays

from gsavatar_torch.data import base as tbase
from gsavatar_torch.motion import series as tseries
from gsavatar_torch.motion import streams as tstreams
from gsavatar_torch.smpl.body_model import synthetic_assets as t_assets

from gsavatar.motion import series as jseries
from gsavatar.smpl.body_model import synthetic_assets as j_assets

F = 4
ATOL = 1e-5


MODES = {
    'default': {},
    'overrides': {'root_orient': np.array([np.pi, 0.0, 0.0], np.float32),
                  'trans': np.array([0.0, 0.2, 2.5], np.float32)},
    'accumulate': {'accumulate': True,
                   'trans_delta': np.array([0.01, 0.0, -0.02], np.float32)},
}


@pytest.fixture(scope='module')
def assets():
    return j_assets(n_verts=6890, seed=0), t_assets(n_verts=6890, seed=0)


@pytest.fixture(scope='module')
def metadata(assets):
    return tbase.canonicalize(assets[1].v_template.copy(), assets[1])


@pytest.mark.parametrize('mode', sorted(MODES))
def test_parse_matches_jax(assets, mode):
    arrays = motion_arrays(F)
    js = jseries.MotionSeries(arrays, assets[0], **MODES[mode])
    ts = tseries.MotionSeries(arrays, assets[1], device='cpu', **MODES[mode])
    assert len(ts) == len(js) == F
    for i in range(F):
        a, b = ts.parse(i), js.parse(i)
        for k in ('root_orient', 'pose_body', 'pose_hand', 'trans',
                  'betas'):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
        for k in ('verts', 'joints', 'bone_transforms'):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=0,
                                       atol=ATOL, err_msg=k)
        ea, eb = a.export(), b.export()
        assert sorted(ea) == sorted(eb)
        for k in ea:
            np.testing.assert_allclose(ea[k], eb[k], rtol=0, atol=ATOL,
                                       err_msg=k)


@pytest.mark.parametrize('mode', sorted(MODES))
def test_camera_pose_fields_match_jax(assets, metadata, mode):
    arrays = motion_arrays(F, seed=1)
    js = jseries.MotionSeries(arrays, assets[0], **MODES[mode])
    ts = tseries.MotionSeries(arrays, assets[1], device='cpu', **MODES[mode])
    for i in range(F):
        got = ts.camera_pose_fields(i, metadata)
        want = js.camera_pose_fields(i, metadata)
        for name, a, b in zip(('rots', 'Jtrs', 'bone_transforms'), got,
                              want):
            assert a.shape == b.shape and a.dtype == np.float32, name
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                       err_msg=name)


def test_npz_file_and_defaults_match_jax(assets, tmp_path):
    """From a file that holds only `pose`: zero shape and translation,
    focal 1000, as the JAX package defaults them."""
    path = str(tmp_path / 'motion.npz')
    np.savez(path, pose=motion_arrays(F, focal=False)['pose'])
    js = jseries.MotionSeries(path, assets[0])
    ts = tseries.MotionSeries(path, assets[1], device='cpu')
    for k in ('pose', 'shape', 'global_t', 'focal_l'):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k), k)
    assert float(ts.focal_l) == 1000.0 and not ts.global_t.any()
    a, b = ts.parse(2), js.parse(2)
    np.testing.assert_allclose(a.bone_transforms, b.bone_transforms, rtol=0,
                               atol=ATOL)
    assert [p.trans.tolist() for p in ts] == [p.trans.tolist() for p in js]


def test_camera_pose_fields_take_parsed_parameters(assets, metadata):
    """Given the parameters of a parse, `camera_pose_fields` does not parse
    again: in accumulate mode the translation advances once per frame."""
    arrays = motion_arrays(F, seed=2)
    delta = MODES['accumulate']['trans_delta']
    ts = tseries.MotionSeries(arrays, assets[1], device='cpu',
                              **MODES['accumulate'])
    for i in range(F):
        p = ts.parse(i)
        _, _, bt = ts.camera_pose_fields(i, metadata, p)
        np.testing.assert_allclose(
            p.trans, arrays['global_t'][i] + (i + 1) * delta, atol=1e-6)
        want = tbase.compose_bone_transforms(
            p.bone_transforms, metadata['bone_transforms_02v'], p.trans)
        np.testing.assert_array_equal(bt, want)
    np.testing.assert_allclose(ts._acc_trans, F * delta, atol=1e-6)


@pytest.mark.parametrize('make', [
    lambda: tstreams.VideoStream('missing.mp4'),
    lambda: tstreams.CameraStream(0),
    lambda: tstreams.ChArucoStream([], np.eye(3)),
    lambda: tstreams.save_video_from_frames([np.zeros((2, 2, 3))], 'x.mp4'),
], ids=['VideoStream', 'CameraStream', 'ChArucoStream',
        'save_video_from_frames'])
def test_streams_name_what_needs_opencv(monkeypatch, make):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='needs OpenCV'):
        make()
