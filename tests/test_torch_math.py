"""gsavatar_torch's math leaves, camera and synthetic data against
gsavatar's: the same numpy inputs through both, f32 on the CPU.

Tolerance 1e-6 relative (with a 1e-6 absolute floor for values near 0):
the functions are elementwise or short fixed-order sums, which the two
frameworks round alike up to an ulp or two."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TINY, close

from gsavatar_torch import config as tconfig
from gsavatar_torch.camera.camera import make_camera as t_make_camera
from gsavatar_torch.data.synthetic import SyntheticDataset as TSynthetic
from gsavatar_torch.ops import sh as tsh
from gsavatar_torch.ops.rasterizer import project as tproject
from gsavatar_torch.smpl import lbs as tlbs
from gsavatar_torch.smpl import vitruvian as tvit
from gsavatar_torch.smpl.body_model import synthetic_assets as t_assets
from gsavatar_torch.utils import transforms as TT

from gsavatar.camera.camera import make_camera as j_make_camera
from gsavatar.config import load_config as j_load_config
from gsavatar.data.synthetic import SyntheticDataset as JSynthetic
from gsavatar.ops import sh as jsh
from gsavatar.ops.rasterizer import project as jproject
from gsavatar.smpl import lbs as jlbs
from gsavatar.smpl import vitruvian as jvit
from gsavatar.smpl.body_model import synthetic_assets as j_assets
from gsavatar.utils import transforms as JT

RTOL, ATOL = 1e-6, 1e-6
rng = np.random.default_rng(0)
Q = rng.normal(size=(64, 4)).astype(np.float32)
Q2 = rng.normal(size=(64, 4)).astype(np.float32)
S = rng.uniform(0.01, 0.2, (64, 3)).astype(np.float32)
M = rng.normal(size=(64, 3, 3)).astype(np.float32)
M2 = rng.normal(size=(64, 3, 3)).astype(np.float32)
V = rng.normal(size=(64, 3)).astype(np.float32)
AA = rng.normal(scale=0.7, size=(64, 3)).astype(np.float32)
U = rng.uniform(0.05, 0.95, (64, 1)).astype(np.float32)

CASES = {
    'inverse_sigmoid': (lambda m: m.inverse_sigmoid, (U,)),
    'quat_normalize': (lambda m: m.quat_normalize, (Q,)),
    'quat_to_rotmat': (lambda m: m.quat_to_rotmat, (Q,)),
    'quat_multiply': (lambda m: m.quat_multiply, (Q, Q2)),
    'matvec3': (lambda m: m.matvec3, (M, V)),
    'matmul3': (lambda m: m.matmul3, (M, M2)),
    'build_scaling_rotation': (lambda m: m.build_scaling_rotation, (S, Q)),
    'strip_symmetric': (lambda m: m.strip_symmetric, (M,)),
    'covariance_quat': (lambda m: lambda s, q: m.covariance_from_scaling_rotation(
        s, 1.3, q), (S, Q)),
    'covariance_matrix': (lambda m: lambda s, r: m.covariance_from_scaling_rotation(
        s, 1.0, r), (S, M)),
    'rodrigues': (lambda m: m.rodrigues, (AA,)),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_transforms(name):
    pick, args = CASES[name]
    want = pick(JT)(*[jnp.asarray(a) for a in args])
    got = pick(TT)(*[torch.from_numpy(a) for a in args])
    close(got, want, RTOL, ATOL, name)


def test_euler_z():
    for deg in (45.0, -45.0, 17.5):
        np.testing.assert_array_equal(TT.euler_z(deg), JT.euler_z(deg))


@pytest.mark.parametrize('deg', [0, 1, 2, 3, 4])
def test_sh_bases(deg):
    d = V / np.linalg.norm(V, axis=1, keepdims=True)
    close(tsh.eval_sh_bases(deg, torch.from_numpy(d)),
          jsh.eval_sh_bases(deg, jnp.asarray(d)), RTOL, ATOL)


def _assets():
    return j_assets(n_verts=300, seed=5), t_assets(n_verts=300, seed=5)


def test_synthetic_assets_identical():
    ja, ta = _assets()
    for f in ('v_template', 'shapedirs', 'posedirs', 'J_regressor',
              'skinning_weights', 'faces', 'parents'):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f), f)


def test_lbs_and_vitruvian():
    ja, _ = _assets()
    pose = rng.normal(scale=0.2, size=(1, 72)).astype(np.float32)
    betas = rng.normal(scale=0.5, size=(1, 10)).astype(np.float32)
    args = (betas, pose, ja.v_template[None], ja.shapedirs, ja.posedirs,
            ja.J_regressor)
    want = jlbs.lbs(*[jnp.asarray(a) for a in args], ja.parents,
                    jnp.asarray(ja.skinning_weights))
    got = tlbs.lbs(*[torch.from_numpy(a) for a in args], ja.parents,
                   torch.from_numpy(ja.skinning_weights))
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, 1e-5, 1e-6, f'lbs output {i}')
    J = np.asarray(want[2][0])
    np.testing.assert_array_equal(tvit.get_02v_bone_transforms(J),
                                  jvit.get_02v_bone_transforms(J))
    close(tvit.get_02v_bone_transforms_torch(torch.from_numpy(J)),
          jvit.get_02v_bone_transforms_jax(jnp.asarray(J)), RTOL, ATOL)


def test_synthetic_cameras_and_metadata():
    jcfg = j_load_config(overrides=["dataset=synthetic"] + TINY).dataset
    tcfg = tconfig.load_config(TINY)['dataset']
    for split in ('train', 'predict'):
        jd, td = JSynthetic(jcfg, split), TSynthetic(tcfg, split)
        jd._render_gt = lambda *_: (np.zeros((64, 64, 3)), np.zeros((64, 64)))
        assert len(jd) == len(td)
        for k in ('smpl_verts', 'Jtr', 'bone_transforms_02v',
                  'skinning_weights'):
            close(td.metadata[k], jd.metadata[k], RTOL, ATOL, k)
        close(td.metadata['aabb'].coord_min, jd.metadata['aabb'].coord_min,
              0, 0)
        close(td.metadata['aabb'].coord_max, jd.metadata['aabb'].coord_max,
              0, 0)
        assert td.metadata['frame_dict'] == jd.metadata['frame_dict']
        for i in range(len(jd)):
            jc, tc = jd[i], td[i]
            for f in ('world_view_transform', 'full_proj_transform',
                      'camera_center', 'rots', 'Jtrs', 'bone_transforms'):
                close(getattr(tc, f), getattr(jc, f), 1e-5, ATOL, f)
            assert (tc.latent_idx, tc.pose_idx, tc.in_frame_dict) == (
                int(jc.latent_idx), int(jc.pose_idx), float(jc.in_frame_dict))
            assert (tc.tanfovx, tc.width, tc.height) == (
                jc.tanfovx, jc.width, jc.height)
        if split == 'train':
            for k in ('root_orient', 'pose_body', 'pose_hand', 'trans',
                      'betas'):
                close(np.asarray(td.metadata[k]), np.asarray(jd.metadata[k]),
                      0, 0, k)
        jp, tp = jd.readPointCloud(), td.readPointCloud()
        np.testing.assert_array_equal(tp[0], jp[0])


def _projection_scene(n=200, seed=1):
    r = np.random.default_rng(seed)
    means = r.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    means[:5, 2] = 2.9  # a few at or behind the near plane
    q = r.normal(size=(n, 4)).astype(np.float32)
    s = (0.05 * (0.3 + r.random((n, 3)))).astype(np.float32)
    cov = np.asarray(JT.covariance_from_scaling_rotation(
        jnp.asarray(s), 1.0, jnp.asarray(q)))
    cam = j_make_camera(R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), fovx=0.8,
                        fovy=0.7, image=np.zeros((72, 88, 3), np.float32),
                        mask=np.zeros((72, 88), np.float32),
                        rots=np.zeros((1, 24, 9)), Jtrs=np.zeros((1, 24, 3)),
                        bone_transforms=np.tile(np.eye(4), (24, 1, 1)))
    return means, cov, cam


def test_project():
    """EWA projection with dilation, fov clamp, radius and tile rects (a
    non-square 88x72 image with a partial tile column and row)."""
    means, cov, cam = _projection_scene()
    active = np.ones(len(means), bool)
    active[7] = False
    args = (means, cov, cam.world_view_transform, cam.full_proj_transform)
    want = jproject.project(*[jnp.asarray(a) for a in args], cam.tanfovx,
                            cam.tanfovy, 88, 72, active=jnp.asarray(active))
    got = tproject.project(*[torch.from_numpy(np.asarray(a)) for a in args],
                           cam.tanfovx, cam.tanfovy, 88, 72,
                           active=torch.from_numpy(active))
    for f in ('means2d', 'depths', 'conics'):
        vis = np.asarray(want.radii) > 0
        close(getattr(got, f).numpy()[vis], np.asarray(getattr(want, f))[vis],
              1e-5, ATOL, f)
    for f in ('radii', 'rect_min', 'rect_max', 'tiles_touched'):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert 0 < int((np.asarray(want.radii) > 0).sum()) < len(means)


def test_make_camera():
    kw = dict(R=np.eye(3, dtype=np.float32),
              T=np.array([0.1, -0.2, 3.0], np.float32), fovx=0.8, fovy=0.6,
              rots=np.zeros((1, 24, 9)), Jtrs=np.zeros((1, 24, 3)),
              bone_transforms=np.tile(np.eye(4), (24, 1, 1)))
    jc = j_make_camera(image=np.zeros((40, 50, 3)), mask=np.zeros((40, 50)),
                       **kw)
    tc = t_make_camera(width=50, height=40, **kw)
    for f in ('world_view_transform', 'full_proj_transform', 'camera_center'):
        close(getattr(tc, f), getattr(jc, f), 0, 0, f)


def _leaves(d, prefix=''):
    for k, v in d.items():
        if isinstance(v, dict) and k != 'test_frames':
            yield from _leaves(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', v


# keys the JAX package reads with a default in its code, not from its yaml
CODE_DEFAULTS = {'opt.bucket_granularity': 4096,    # gsavatar/scene.py:253
                 'log_every': 10,                   # gsavatar/train.py:798
                 'max_val_frames': None,            # gsavatar/train.py:546
                 'strict_overflow': False}          # gsavatar/train.py:758


DATASET_GROUPS = ['synthetic'] + sorted(tconfig.DATASETS)


# every choice of the model and option groups, one at a time, and the
# plain-3DGS baseline of the JAX package's variant test
GROUP_CHOICES = [[f'{g}={c}'] for g in sorted(tconfig.GROUPS)
                 for c in sorted(tconfig.GROUPS[g])] + [
    ['texture=sh', 'non_rigid=identity', 'rigid=identity',
     'pose_correction=none'],
    ['non_rigid=hannw_mlp', 'texture=sh', 'option=no_val']]


def _assert_matches(got, want, label):
    for key, value in _leaves(got):
        if key in CODE_DEFAULTS:
            assert value == CODE_DEFAULTS[key], key
            continue
        node = want
        for part in key.split('.'):
            node = node[part]
        node = node.to_dict() if hasattr(node, 'to_dict') else node
        assert value == node, (label, key)


def test_config_matches_yaml_defaults():
    """Every key of the port's config equals the JAX package's composed
    config for each dataset group the port serves (synthetic and the
    eleven real subjects, with their `opt:` keys and the
    `${dataset.val_views}` interpolation resolved after the overrides),
    and for every choice of the pose_correction, texture, rigid, non_rigid
    and option groups (the model block whole, `${...}` resolved across
    groups: `non_rigid.feature_dim` follows `texture.non_rigid_dim`), with
    overrides applied alike, or the default the JAX code reads it with."""
    ov = ["dataset.img_hw=[540,540]", "model.gaussian.capacity=131072",
          "dataset.val_views=['5','6']"]
    for group in DATASET_GROUPS:
        want = j_load_config(overrides=[f"dataset={group}"] + ov)
        got = tconfig.load_config([f"dataset={group}"] + ov)
        _assert_matches(got, want, group)
        if group.startswith('zjumocap'):
            assert got['dataset']['test_views']['view'] == ['5', '6']
        if group != 'synthetic':
            # every dataset key of the group's yaml and the root's, but the
            # `mode` copy that no loader reads
            assert {k for k, _ in _leaves(got['dataset'])} >= {
                k for k, _ in _leaves(want['dataset'].to_dict())} - {'mode'}
    assert tconfig.load_config(["dataset=ps_female_3"])['opt'][
        'densify_grad_threshold'] == 0.0001
    for choices in GROUP_CHOICES:
        want = j_load_config(overrides=["dataset=synthetic"] + choices + ov)
        got = tconfig.load_config(choices + ov)
        _assert_matches(got, want, choices)
        assert got['model'] == want['model'].to_dict(), choices
        assert got['name'] == want['name'], choices
        assert got['dataset']['train_smpl'] == want['dataset']['train_smpl']
    sh = tconfig.load_config(['texture=sh'])
    assert sh['model']['gaussian']['use_sh'] is True
    assert sh['model']['deformer']['non_rigid']['feature_dim'] == 0
    assert tconfig.load_config(['model.deformer.rigid.distill=true'])[
        'model']['deformer']['rigid']['distill'] is True


def test_synthetic_is_the_port_default():
    """The port's default dataset is synthetic; the JAX package's is
    zjumocap_377_mono (config.yaml)."""
    assert tconfig.load_config()['dataset']['name'] == 'synthetic'
    assert tconfig.load_config() == tconfig.load_config(
        ["dataset=synthetic"])
    assert j_load_config().dataset.name == 'zjumocap'


def test_config_groups_take_only_the_default():
    """Each group admits exactly the choices the JAX package has a file
    for (`gsavatar/config/configs/<group>/`); any other choice raises,
    and naming a group's default changes nothing."""
    import os
    from gsavatar.config.config import DEFAULT_CONFIG_DIR
    for group, choices in tconfig.GROUPS.items():
        files = {f[:-5] for f in os.listdir(os.path.join(DEFAULT_CONFIG_DIR,
                                                         group))}
        assert set(choices) == files, group
        assert tconfig.DEFAULT_GROUPS[group] in choices
    with pytest.raises(ValueError):
        tconfig.load_config(["texture=foo"])
    with pytest.raises(ValueError):
        tconfig.load_config(["dataset=zjumocap_999_mono"])
    assert tconfig.load_config(["texture=shallow_mlp"]) == \
        tconfig.load_config()


def _near_half_turns():
    """Rotations by 179.9-180 degrees about axes near x, y and z (each
    fires one of the non-trace branches of Shepperd's method), about a
    tilted axis, and by small angles (the trace branch)."""
    from scipy.spatial.transform import Rotation
    axes = np.array([[1, 0.01, -0.02], [0.02, 1, 0.01], [-0.01, 0.02, 1],
                     [1, 1, 0.3], [0.2, -1, 1]], np.float64)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    rots = [axes * np.deg2rad(a) for a in (180.0, 179.99, 179.9, 120.0, 1.0)]
    return Rotation.from_rotvec(np.concatenate(rots)).as_matrix().astype(
        np.float32)


def test_rotmat_to_quat_matches_jax():
    """On test_math_core.py's inputs (128 unit quaternions made matrices
    by JAX's quat_to_rotmat) and on near-half-turn matrices where each
    branch of the selection fires: within 1e-6 absolute."""
    q = np.random.default_rng(3).normal(size=(128, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mats = np.asarray(JT.quat_to_rotmat(jnp.asarray(q)))
    for m in (mats, _near_half_turns()):
        m = np.ascontiguousarray(m, np.float32)
        want = np.asarray(JT.rotmat_to_quat(jnp.asarray(m)))
        got = TT.rotmat_to_quat(torch.tensor(m)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # every branch fired on the second set
    m = _near_half_turns()
    d = np.stack([m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]], 1)
    trace = d.sum(1)
    assert (trace > 0).any()
    assert {int(np.argmax(r)) for r, t in zip(d, trace) if t <= 0} == \
        {0, 1, 2}


def test_unstrip_symmetric_matches_jax():
    rng = np.random.default_rng(6)
    A = rng.normal(size=(8, 3, 3))
    S = (A @ np.transpose(A, (0, 2, 1))).astype(np.float32)
    u = np.asarray(JT.strip_symmetric(jnp.asarray(S)))
    want = np.asarray(JT.unstrip_symmetric(jnp.asarray(u)))
    got = TT.unstrip_symmetric(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, S, rtol=0, atol=1e-6)


def test_load_config_from_dict_matches_jax():
    """`${...}` resolved whole (keeping the referee's type) and inside
    strings, nested references, YAML 1.1's exponent strings made floats,
    on a deep copy (the given dict unchanged); a cycle raises as JAX's
    does."""
    import copy
    from gsavatar.config.config import load_config_from_dict as j_from_dict
    data = {'a': {'b': 3, 'c': [1, '${a.b}'], 'lr': '1e-4',
                  'tag': 'run_${a.b}_${name}'},
            'name': 'x${a.b}', 'ref': '${a}', 'views': '${a.c}',
            'deep': {'d': '${a.tag}'}}
    before = copy.deepcopy(data)
    got = tconfig.load_config_from_dict(data)
    assert got == j_from_dict(data).to_dict()
    assert data == before
    assert got['a']['lr'] == 1e-4 and got['ref']['c'] == [1, 3]
    got['ref']['c'].append(0)
    assert got['a']['c'] == [1, 3]
    loop = {'x': '${y}', 'y': '${x}'}
    with pytest.raises(ValueError, match='cycle'):
        tconfig.load_config_from_dict(loop)
    with pytest.raises(ValueError, match='cycle'):
        j_from_dict(loop)
