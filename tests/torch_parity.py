"""Shared set-up for the parity tests of gsavatar_torch against gsavatar.

One tiny synthetic avatar (the sizes of tests/test_train_e2e.py) built by
both packages from the same config, and converter weights drawn with numpy
from a seed, handed to JAX as a flax tree and to the port through
`gsavatar_torch.convert`. The JAX side runs on the CPU; its dataset's
ground-truth render is replaced by zeros (no parity test reads it)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

TINY = [
    "dataset.img_hw=[64,64]",
    "dataset.n_verts=512",
    "dataset.n_points=768",
    "dataset.train_frames=[0,2,1]",
    "dataset.train_views=['0']",
    "model.gaussian.capacity=1024",
    "rasterizer.max_pairs=65536",
]
ITERATION = 15000  # past every delay gate, as at inference


def random_conv_params(shapes, metadata, seed=0):
    """Numpy converter weights of the flax tree `shapes`: uniform kernels
    at torch's default scale, larger-than-init hash-table entries (so that
    their bf16 rounding shows), N(0, 1) latents, pose tables near the
    dataset's ground truth."""
    rng = np.random.default_rng(seed)
    pose_init = {'root_orients': 'root_orient', 'pose_bodys': 'pose_body',
                 'pose_hands': 'pose_hand', 'trans': 'trans'}

    def leaf(path, s):
        name = str(getattr(path[-1], 'key', path[-1]))
        if name == 'kernel':
            b = 1.0 / np.sqrt(s.shape[0])
            return rng.uniform(-b, b, s.shape)
        if name == 'bias':
            return rng.uniform(-0.1, 0.1, s.shape)
        if name == 'table':
            return rng.uniform(-0.05, 0.05, s.shape)
        if name == 'embedding':
            return rng.normal(size=s.shape)
        if name == 'betas':
            return rng.normal(scale=0.5, size=s.shape)
        base = np.asarray(metadata[pose_init[name]], np.float64)
        return base.reshape(s.shape) + rng.normal(scale=0.05, size=s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes)


class JaxAvatar:
    """The JAX package's tiny avatar: datasets, converter, weights, arena,
    a camera and the hash-grid cache; `overrides` (config groups and dotted
    keys) select a model variant."""

    def __init__(self, frame: int = 1, seed: int = 0, overrides=()):
        from gsavatar.config import load_config
        from gsavatar.core import gaussians as G
        from gsavatar.data.synthetic import SyntheticDataset
        from gsavatar.models.converter import build_converter, compute_nr_cache

        self.cfg = load_config(overrides=["dataset=synthetic"] + TINY
                               + list(overrides))
        self.train = SyntheticDataset(self.cfg.dataset, 'train')
        self.predict = SyntheticDataset(self.cfg.dataset, 'predict')
        h, w = self.cfg.dataset.img_hw
        self.predict._render_gt = lambda *_: (
            np.zeros((h, w, 3), np.float32), np.zeros((h, w), np.float32))
        self.camera = self.predict[frame]
        self.converter = build_converter(self.cfg, self.train.metadata,
                                         assets=self.train.assets)
        pts, cols = self.train.readPointCloud()
        g = self.cfg.model.gaussian
        self.gauss_params, self.gauss_aux = jax.jit(
            lambda p, c: G.create_from_pcd(
                p, c, int(g.capacity), bool(g.use_sh), int(g.sh_degree),
                int(g.get('feature_dim', 32))))(
            jnp.asarray(pts), jnp.asarray(cols))
        self.gview = G.make_view(self.gauss_params, self.gauss_aux,
                                 use_sh=bool(g.use_sh))
        # the variables' structure: 'params' and the 'subject' constants
        self.shapes = jax.eval_shape(lambda: self.converter.init(
            jax.random.PRNGKey(0), self.gview, self.camera, 0))
        self.params = random_conv_params(self.shapes.get('params', {}),
                                         self.train.metadata, seed)
        self.variables = {'params': jax.tree.map(jnp.asarray, self.params)}
        # eagerly, as the JAX package's evaluate and InferenceScene do (under
        # jit XLA rounds the AABB normalization differently by an ulp)
        self.nr_cache = compute_nr_cache(self.converter, self.variables,
                                         self.gview)


class TorchAvatar:
    """The port's tiny avatar, its weights and arena carried over from a
    JaxAvatar."""

    def __init__(self, ja: JaxAvatar, frame: int = 1, overrides=()):
        from gsavatar_torch import convert
        from gsavatar_torch.config import load_config
        from gsavatar_torch.core import gaussians as G
        from gsavatar_torch.data.synthetic import SyntheticDataset
        from gsavatar_torch.inference import AvatarState

        self.cfg = load_config(TINY + list(overrides))
        self.train = SyntheticDataset(self.cfg['dataset'], 'train')
        self.predict = SyntheticDataset(self.cfg['dataset'], 'predict')
        self.camera = self.predict[frame]
        params, aux = convert.arena(
            jax.tree.map(np.asarray, ja.gauss_params),
            jax.tree.map(np.asarray, ja.gauss_aux))
        self.state = AvatarState(params, aux,
                                 convert.converter_state(ja.params))
        self.gview = G.make_view(
            params, aux, use_sh=bool(self.cfg['model']['gaussian']['use_sh']))


def jax_draws(rng, rots_shape, n_reg, pool_size, pose_noise, view_noise,
              frames=1):
    """The draws of one JAX step over `frames` frames from its state's key,
    one `TrainDraws` per frame, and the next key: `split(step_key,
    frames)[b]` is frame b's key (`gsavatar/parallel/shard.py:110-112, 124`;
    with one frame `gsavatar/train.py:235-237`), then converter.py:41-50,
    transforms.py:184 and train.py:153."""
    from gsavatar_torch.train import TrainDraws
    rng, step_key = jax.random.split(rng)
    out = []
    for key in jax.random.split(step_key, frames):
        k_noise, k_skin = jax.random.split(key)
        k_gate, k_pose, k_view = jax.random.split(k_noise, 3)
        k1, k2, k3 = jax.random.split(k_view, 3)
        v = view_noise
        angles = jnp.stack([
            jnp.clip(jax.random.normal(k1) * v, -2 * v, 2 * v),
            jnp.clip(jax.random.uniform(k2) * v, -2 * v, 2 * v),
            jnp.clip(jax.random.normal(k3) * v, -2 * v, 2 * v)])
        assert pose_noise > 0
        out.append(TrainDraws(
            pose_apply=float(jax.random.uniform(k_gate) <= 0.5),
            pose_noise=torch.from_numpy(np.asarray(
                jax.random.normal(k_pose, rots_shape))),
            view_angles=torch.from_numpy(np.asarray(angles)),
            sel=torch.from_numpy(np.asarray(
                jax.random.randint(k_skin, (n_reg,), 0, pool_size))).long()))
    return rng, out


# the shape of the step parity tests, defined beside the multi-process
# tests' ranks, which import no JAX (the import also puts torch on one
# thread)
from torch_dist_workers import STEP_TINY  # noqa: E402,F401


def grad_gate(got, want, name, cos_min=0.999, rel_max=1e-3):
    """bench.py's gradient gate on one leaf: mean error < 1e-3 of the
    largest |value| and a cosine > 0.999."""
    a = to_np(got).astype(np.float64).ravel()
    b = np.asarray(want, np.float64).ravel()
    if not np.abs(b).max() > 0:
        assert not np.abs(a).max() > 1e-6, name
        return
    rel = np.abs(a - b).mean() / max(np.abs(b).max(), 1e-12)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > cos_min and rel < rel_max, (name, cos, rel)


def jax_named(tree):
    """A JAX converter tree ({'params': ...}, leaves of one optimizer group
    or all) as numpy arrays under the port's state-dict names, through
    gsavatar_torch.convert (kernels transposed); masked leaves dropped."""
    from gsavatar_torch import convert

    def strip(t):
        if isinstance(t, dict):
            kept = {k: strip(v) for k, v in t.items()}
            return {k: v for k, v in kept.items() if v is not None}
        return None if type(t).__name__ == 'MaskedNode' else t
    return {k: v.numpy() for k, v in convert.converter_state(
        jax.tree.map(np.asarray, strip(tree['params']))).items()}


def jax_conv_mu(conv_opt):
    """The converter's Adam first moments in the JAX optimizer state (clip,
    then per group [add_decayed_weights], adam, schedule), by name."""
    out = {}
    for group, st in conv_opt[1].inner_states.items():
        adam = [x for x in st.inner_state if hasattr(x, 'mu')]
        if adam:
            out.update(jax_named(adam[0].mu))
    return out


def carry_state(scene, state, carried):
    """Load a `convert.CarriedState` (a JAX state's converter weights,
    arena and arena Adam) into a port scene and its state."""
    scene.converter.load_state_dict(carried.converter)
    state.gauss_params = carried.gauss_params
    state.gauss_aux = carried.gauss_aux
    state.gauss_adam = carried.gauss_adam
    return state


def close(a, b, rtol, atol, name=''):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=rtol, atol=atol,
                               err_msg=name)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_render_gates(got, want, name):
    """bench.py's parity gates: mean error < 1e-4 and a fraction < 1e-3 of
    pixels off by more than 1e-2."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.mean() < 1e-4, (name, d.mean())
    assert (d > 1e-2).mean() < 1e-3, (name, (d > 1e-2).mean())


def smooth_frame(h, w, seed, grey=False):
    """Smooth colour fields with a little noise (what a camera sees)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([128 + 100 * np.sin(6 * x + 6 * rng.random() + 3 * y),
                    128 + 90 * np.cos(9 * y + rng.random()),
                    128 + 60 * np.sin(5 * (x + y))], -1)
    img += rng.normal(0, 12, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def motion_arrays(n, seed=0, global_z=3.0, focal=True):
    """A CLIFF-style motion (pose (n, 72), shape (n, 10), global_t (n, 3),
    focal_l) from a numpy seed: small body rotations, the body about
    `global_z` in front of the camera."""
    rng = np.random.default_rng(seed)
    out = {'pose': (0.2 * rng.standard_normal((n, 72))).astype(np.float32),
           'shape': (0.5 * rng.standard_normal((n, 10))).astype(np.float32),
           'global_t': (np.array([0.0, 0.1, global_z])
                        + 0.05 * rng.standard_normal((n, 3))
                        ).astype(np.float32)}
    if focal:
        out['focal_l'] = np.float32(1100.0)
    return out


def write_torch_checkpoint(path, state, iteration):
    """A checkpoint file of the port's format (`Scene.save_checkpoint`)
    holding an AvatarState; the optimizer states are zeros."""
    import dataclasses

    def fields(p):
        return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}

    zeros = {k: torch.zeros_like(v)
             for k, v in fields(state.gauss_params).items()}
    torch.save({'gauss_params': fields(state.gauss_params),
                'gauss_aux': fields(state.gauss_aux),
                'gauss_adam': {'m': zeros, 'v': zeros, 'step': 0},
                'converter': state.converter,
                'conv_opt': {'mu': {}, 'nu': {}, 'count': 0},
                'generator': torch.Generator().get_state(),
                'iteration': iteration}, str(path))
    return str(path)


# the compositor's grid for the tile-range tests: 4 x 4 tiles of a 64 x 64
# image, and the JAX kernels' chunk of pair rows
GRID = 4
TILES = GRID * GRID
PAIR_CHUNK = 32


def grid_pairs(n=120, seed=5):
    """tests/test_torch_raster.py's random scene of n Gaussians through the
    port's project and pair build on the 4 x 4 grid of a 64 x 64 image:
    (pair_data, tile_start) and a cotangent of the compositor's output,
    uniform in [-1, 1]."""
    from gsavatar_torch.ops.rasterizer.pairs import build_pairs
    from gsavatar_torch.ops.rasterizer.project import project
    from gsavatar.camera.camera import make_camera
    from gsavatar.utils.transforms import covariance_from_scaling_rotation
    H = W = 64
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    s = (0.05 * (0.5 + rng.random((n, 3)))).astype(np.float32)
    cov = np.asarray(covariance_from_scaling_rotation(
        jnp.asarray(s), 1.0, jnp.asarray(q)))
    colors = rng.random((n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, (n, 1)).astype(np.float32)
    cam = make_camera(R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), fovx=0.8,
                      fovy=0.8, image=np.zeros((H, W, 3), np.float32),
                      mask=np.zeros((H, W), np.float32),
                      rots=np.zeros((1, 24, 9)), Jtrs=np.zeros((1, 24, 3)),
                      bone_transforms=np.tile(np.eye(4), (24, 1, 1)))
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    proj = project(t(means), t(cov), t(cam.world_view_transform),
                   t(cam.full_proj_transform), cam.tanfovx, cam.tanfovy, W, H)
    pa = build_pairs(proj, t(colors), t(opac), GRID, GRID, 2 ** 13)
    assert pa.n_pairs > 0 and pa.pair_overflow == 0
    ct = rng.uniform(-1.0, 1.0, (TILES, 8, 256)).astype(np.float32)
    return pa.pair_data, pa.tile_start, torch.from_numpy(ct)


def padded_pairs(pair_data):
    """pair_data as the JAX kernels take it: PAIR_CHUNK rows of tail
    padding, PAIR_LANES lanes."""
    from gsavatar.ops.rasterizer.pallas_composite import PAIR_LANES
    pd = np.zeros((pair_data.shape[0] + PAIR_CHUNK, PAIR_LANES), np.float32)
    pd[:pair_data.shape[0], :12] = pair_data.numpy()
    return jnp.asarray(pd)


def tile_column_scale(values, tile_start):
    """|values| (P, C) -> the largest |value| of each row's column in the
    row's tile, per element."""
    ts = np.asarray(tile_start)
    v = np.abs(np.asarray(values))
    out = np.zeros_like(v)
    for t in range(len(ts) - 1):
        if ts[t + 1] > ts[t]:
            out[ts[t]:ts[t + 1]] = v[ts[t]:ts[t + 1]].max(0)
    return out
