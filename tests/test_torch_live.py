"""The port's live camera (gsavatar_torch/camera/live.py) against the JAX
package's: the transposed world-to-view matrix with the translation in its
last row, the full projection, the camera centre, the field of view from K
or from CLIFF's focal estimate, and the pose fields' defaults. Tolerances:
every matrix to 1e-6 relative, the centre to 1e-5, the focal estimate and
the fields of view equal."""
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from torch_parity import to_np

from gsavatar_torch.camera import live as tlive

from gsavatar.camera import live as jlive

CASES = {
    'identity_default_K': (np.eye(3), [0.0, 0.0, 2.5], None, 512, 512),
    'orbit_720p': (Rotation.from_rotvec([0.0, 0.7, 0.0]).as_matrix(),
                   [0.1, -0.2, 3.0], None, 1280, 720),
    'board_pose_K': (Rotation.from_rotvec([0.3, -0.2, 0.1]).as_matrix(),
                     [0.4, 0.05, 1.6],
                     np.array([[900.0, 0, 611.5], [0, 905.0, 355.2],
                               [0, 0, 1]], np.float32), 1280, 720),
}


@pytest.mark.parametrize('h,w', [(720, 1280), (512, 512), (1080, 1920),
                                 (37, 53)])
def test_estimate_focal_length_equal(h, w):
    assert tlive.estimate_focal_length(h, w) == \
        jlive.estimate_focal_length(h, w)


@pytest.mark.parametrize('case', sorted(CASES))
def test_live_camera_matches_jax(case):
    R, T, K, w, h = CASES[case]
    R = np.asarray(R, np.float32)
    T = np.asarray(T, np.float32)
    rng = np.random.default_rng(len(case))
    pose = dict(rots=rng.normal(size=(1, 24, 9)).astype(np.float32),
                Jtrs=rng.normal(size=(1, 24, 3)).astype(np.float32),
                bone_transforms=rng.normal(size=(24, 4, 4)).astype(np.float32))
    want = jlive.live_camera(R, T, K=K, width=w, height=h, frame_id=3,
                             **pose)
    got = tlive.live_camera(R, T, K=K, width=w, height=h, frame_id=3,
                            device='cpu', **pose)
    for name in ('world_view_transform', 'full_proj_transform'):
        np.testing.assert_allclose(to_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_allclose(to_np(got.camera_center),
                               np.asarray(want.camera_center), rtol=1e-5,
                               atol=1e-5)
    for name in ('rots', 'Jtrs', 'bone_transforms'):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_array_equal(got.K, want.K)
    assert (got.fovx, got.fovy, got.width, got.height, got.frame_id) == \
        (want.fovx, want.fovy, want.width, want.height, want.frame_id)
    assert (got.latent_idx, got.pose_idx, got.in_frame_dict) == \
        (int(want.latent_idx), int(want.pose_idx), float(want.in_frame_dict))
    assert got.world_view_transform.dtype == torch.float32


def test_live_camera_pose_defaults_match_jax():
    R, T = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    want = jlive.live_camera(R, T)
    got = tlive.live_camera(R, T, device='cpu')
    for name in ('rots', 'Jtrs', 'bone_transforms'):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    assert (got.width, got.height) == (1280, 720)
    np.testing.assert_array_equal(got.K, want.K)


def test_live_camera_needs_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match='GPU'):
        tlive.live_camera(np.eye(3), np.zeros(3))
