"""The work the algorithm needs, counted from shapes and pair counts: f32
operations (a multiply-add is two) and HBM bytes (each input byte read
once, each output byte written once). What a particular kernel does more
(a pair walked twice, a row re-read) is not counted, so a later PR that
fuses or replaces a kernel leaves every count as it is.

Counts are per frame or per training step; `frame_counts` and
`step_counts` add them up over a traced slice under the keys the metric
readers read."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

from perfbench.reference.plain.models.mlp import _layer_dims
from perfbench.reference.plain.ops.lpips import VGG

TILE_PIXELS = 256          # a 16 x 16 tile
PAIR_LIVE_COLS = 9         # m2d x, y, conic a, b, c, colour r, g, b, opacity
# one (pair, pixel) evaluation: dx, dy, the conic's quadratic form and its
# sign test, exp, the opacity product, the clamp and the alpha test
EVAL_OPS = 16
# the compositor's live output rows: colour r, g, b, alpha, final T
OUT_ROWS = 5
# the rows of the AIAP terms' four neighbour gathers: xyz (3) canonical and
# deformed, covariance (6) canonical and deformed
AIAP_WIDTHS = (3, 3, 6, 6)
K_NEIGHBORS = 5
BONES = 24
# the SMPL template's vertices, where the dataset names no count
SMPL_VERTS = 6890
# one (point, template vertex) pair of the nearest-vertex search: three
# differences, three squares, two adds and the comparison with the nearest
SEARCH_OPS = 9
# the blend of the bone transforms by a point's skinning weights, and the
# 4x4 transform of its position
BLEND_OPS = 2 * BONES * 16 + 2 * 12


def dense_ops(layers: Sequence[Tuple[int, int]]) -> int:
    """One row through dense layers of (fan_in, fan_out) (biases and
    activations left out)."""
    return sum(2 * a * b for a, b in layers)


def mlp_layers(dim_in: int, dim_cond: int, dim_out: int, mlp: dict,
               hannw: bool = False):
    """(fan_in, fan_out) of each layer of the reference's conditional MLP
    (`models/mlp.py`) on an input of `dim_in` columns: its positional
    encoding, dim_in * (1 + 2 * multires) wide (the Hann-window one has no
    identity part), then `_layer_dims`: a `cond_in` layer also takes the
    condition, a `skip_in` layer the encoded input, and the layer before a
    skip gives up as many outputs."""
    multires = int(mlp.get('multires', 0))
    width = dim_in * (2 * multires + (not hannw)) if multires > 0 else dim_in
    dims = [width] + [int(mlp['n_neurons'])] * int(mlp['n_hidden_layers']) \
        + [dim_out]
    return _layer_dims(dims, dim_cond, tuple(mlp.get('skip_in', ())),
                       tuple(mlp.get('cond_in', ())))


def k1(pairs: int, tiles: int) -> Dict[str, int]:
    """K1, the compositor forward: every pair evaluated at the 256 pixels
    of its tile; the pairs' live columns and tile ranges read, the live
    output rows written."""
    return {'ops': EVAL_OPS * TILE_PIXELS * pairs,
            'bytes': 4 * (pairs * PAIR_LIVE_COLS + tiles + 1
                          + tiles * OUT_ROWS * TILE_PIXELS)}


def k2(pairs: int, tiles: int) -> Dict[str, int]:
    """K2, the compositor backward: the same evaluations; the pairs, the
    tile ranges, the cotangent's and the forward output's live rows read,
    one gradient row of live columns per pair written."""
    return {'ops': EVAL_OPS * TILE_PIXELS * pairs,
            'bytes': 4 * (2 * pairs * PAIR_LIVE_COLS + tiles + 1
                          + 2 * tiles * OUT_ROWS * TILE_PIXELS)}


def segsum(rows: int, cols: int, segments: int) -> Dict[str, int]:
    """K3, one sorted segment sum: each value row and its id read once,
    each segment's sum written once, one add per value."""
    return {'ops': rows * cols,
            'bytes': 4 * (rows * (1 + cols) + segments * cols)}


def k3_step(n: int, pairs: int, hash_levels: int = 0,
            hash_features: int = 0, hash_rows: int = 0) -> Dict[str, int]:
    """K3's launches in a training step over n arena rows: the pair
    gradients onto the Gaussians, the four AIAP gathers' transposes and,
    with a hash grid, its table's gradient (8 corners a level)."""
    parts = [segsum(pairs, PAIR_LIVE_COLS, n)]
    parts += [segsum(n * K_NEIGHBORS, c, n) for c in AIAP_WIDTHS]
    if hash_levels:
        parts.append(segsum(n * hash_levels * 8, hash_features,
                            hash_levels * hash_rows))
    return {k: sum(p[k] for p in parts) for k in ('ops', 'bytes')}


def hashgrid_ops(n: int, levels: int, features: int) -> int:
    """The trilinear read of one point at every level: 8 corner weights
    (three products each) and a multiply-add per corner and feature."""
    return n * levels * 8 * (3 + 2 * features)


def vgg_ops(stages, h: int, w: int) -> int:
    """One image through LPIPS's backbone (`ops/lpips.py`'s stage table:
    an optional (kernel, stride) max-pool, then (out, kernel, stride, pad)
    convolutions), the convolutions' multiply-adds."""
    ops, c = 0, 3
    for stage in stages:
        if stage['pool'] is not None:
            k, s = stage['pool']
            h, w = (h - k) // s + 1, (w - k) // s + 1
        for out, k, s, pad in stage['convs']:
            h, w = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
            ops += 2 * h * w * c * out * k * k
            c = out
    return ops


def ssim_ops(h: int, w: int, channels: int = 3, window: int = 11) -> int:
    """SSIM's five separable blurs (two passes of `window` taps)."""
    return 5 * 2 * 2 * window * channels * h * w


# the texture's message where the deformer gives it no non-rigid feature
# (`models/texture.py:ColorMLP.forward`)
NO_FEATURE = ("the texture takes a non-rigid feature of {} columns, but the "
              "non-rigid deformer gives none (the identity deformer without "
              "a feature_dim, or hannw_mlp): pair it with a texture of "
              "non_rigid_dim 0 (texture=sh)")


class ConverterWork:
    """The converter's f32 operations for one configuration, from its
    widths, for every choice of the port's config groups:

    - non-rigid: nothing (`identity`); the pose-conditioned MLP on the
      positional encoding of the position (`mlp`; `hannw_mlp`, whose deltas
      are computed, then zeroed before `kick_in_iter`), or on the hash-grid
      encoding (`hashgrid`: cached at eval, read with its transpose in a
      step);
    - rigid: nothing (`identity`); else the blend of the 24 bone transforms
      by skinning weights from the nearest template vertex (`smpl_nn`: a
      distance to every vertex, with no backward), from the skinning
      field's MLP at the point, or, distilled, from a trilinear sample of
      the field's voxel, which the MLP builds over its (res / z_ratio) x
      res x res cells: once an avatar at eval, and in every step forward
      and backward, since the voxel follows the MLP's parameters;
    - texture: SH evaluation (`sh`), or the colour MLP on the features, the
      optional position, covariance and normal, the view's SH bases, the
      non-rigid feature and the latent (`shallow_mlp`, `mlp`).

    The pose encoder, pose correction and latent lookups run once a frame
    and are not counted. A configuration the reference's converter refuses
    raises its ValueError. Per point: `dense` (the MLP layers of a frame),
    `per_point` (all of a frame's work but the search) and `search`; once:
    `voxel` (one build); per row of the skinning loss: `skin_row`."""

    def __init__(self, cfg: dict):
        m = cfg['model']
        nr, rg = m['deformer']['non_rigid'], m['deformer']['rigid']
        tex = m['texture']
        self.hash = None
        self.dense = self.search = self.voxel = self.skin_row = 0
        extra = 0                       # per point, beyond the MLP layers
        feature = int(nr.get('feature_dim', 0))
        if nr['name'] in ('mlp', 'hannw_mlp', 'hashgrid'):
            pe = nr['pose_encoder']
            cond = int(pe['out_dim'])
            if cond <= 0:
                cond = int(pe['num_joints']) * int(pe['dim_per_joint'])
            cond += int(nr.get('latent_dim', 0))
            dim_in = 3
            if nr['name'] == 'hashgrid':
                hg = nr['hashgrid']
                self.hash = (int(hg['n_levels']),
                             int(hg['n_features_per_level']),
                             1 << int(hg['log2_hashmap_size']))
                dim_in = self.hash[0] * self.hash[1]
            if nr['name'] == 'hannw_mlp':
                feature = 0
            self.dense += dense_ops(mlp_layers(
                dim_in, cond, 10 + feature, nr['mlp'],
                hannw=nr['name'] == 'hannw_mlp'))
        elif nr['name'] != 'identity':
            raise ValueError(f"unknown non-rigid deformer: {nr['name']}")

        if rg['name'] == 'smpl_nn':
            self.search = SEARCH_OPS * int(
                cfg['dataset'].get('n_verts', SMPL_VERTS))
            extra += BLEND_OPS
        elif rg['name'] == 'skinning_field':
            net = rg['skinning_network']
            # the field's MLP takes no condition and no skip
            field = dense_ops(mlp_layers(
                3, 0, int(rg['d_out']),
                {'n_neurons': net['n_neurons'],
                 'n_hidden_layers': net['n_hidden_layers'],
                 'multires': net['multires']}))
            if rg['distill']:
                res = int(rg['res'])
                self.voxel = field * (res // int(rg['z_ratio'])) * res * res
                # a point or a skinning-loss row: a trilinear sample of the
                # voxel's 24 channels
                self.skin_row = hashgrid_ops(1, 1, BONES)
                extra += self.skin_row
            else:
                self.skin_row = field
                self.dense += field
            extra += BLEND_OPS
        elif rg['name'] != 'identity':
            raise ValueError(f"unknown rigid deformer: {rg['name']}")

        if tex['name'] == 'mlp':
            sh = int(tex['sh_degree'])
            nr_dim = int(tex['non_rigid_dim'])
            if nr_dim > 0 and feature == 0:
                raise ValueError(NO_FEATURE.format(nr_dim))
            dim_in = (int(tex['feature_dim']) + 3 * bool(tex['use_xyz'])
                      + 6 * bool(tex['use_cov'])
                      + 3 * bool(tex['use_normal'])
                      + ((sh + 1) ** 2 - 1 if sh > 0 else 0)
                      + nr_dim + int(tex['latent_dim']))
            self.dense += dense_ops(mlp_layers(dim_in, 0, 3, tex['mlp']))
        elif tex['name'] in ('sh2rgb', 'sh'):
            deg = int(m['gaussian']['sh_degree'])
            extra += 2 * 3 * (deg + 1) ** 2
        else:
            raise ValueError(f"unknown texture: {tex['name']}")

        pc = m['pose_correction']['name']
        if pc not in ('none', 'direct'):
            raise ValueError(f"unknown pose correction: {pc}")
        self.per_point = self.dense + extra

    def frame_ops(self, n: int) -> int:
        """A frame at eval over n Gaussians: the hash-grid encoding and the
        distilled voxel are built once an avatar, so neither counts."""
        return (self.per_point + self.search) * n

    def step_ops(self, n: int, skin_rows: int) -> int:
        """A training step: the forward and the backward (input and weight
        gradients, twice the forward) of the per-point work, the voxel's
        build and the skinning loss's field on its minibatch; the search
        forward only; the hash-grid reads and their transposes."""
        ops = 3 * (self.per_point * n + self.voxel
                   + self.skin_row * skin_rows) + self.search * n
        if self.hash:
            ops += 2 * hashgrid_ops(n, self.hash[0], self.hash[1])
        return ops


def tiles(cfg: dict) -> int:
    """The 16 x 16 tiles of the configuration's frame."""
    h, w = cfg['dataset']['img_hw']
    return ((w + 15) // 16) * ((h + 15) // 16)


def frame_counts(cfg: dict, pairs: Sequence[int],
                 n_alive: int) -> Dict[str, int]:
    """A traced slice of playback frames, one pair count a frame: K1's
    operations and bytes, and every frame's operations (K1 and the
    converter over `n_alive` Gaussians)."""
    conv, t = ConverterWork(cfg), tiles(cfg)
    c = {'k1_ops': 0, 'k1_bytes': 0, 'ops': 0}
    for p in pairs:
        one = k1(p, t)
        c['k1_ops'] += one['ops']
        c['k1_bytes'] += one['bytes']
        c['ops'] += one['ops'] + conv.frame_ops(n_alive)
    return c


def step_counts(cfg: dict,
                steps: Sequence[Tuple[int, int]]) -> Dict[str, int]:
    """A traced slice of training steps, (pair count, arena rows) a step:
    K1's, K2's and K3's operations and bytes, and every step's operations
    (the converter's, LPIPS on both crops with the render's backward, SSIM
    forward and backward, and the three kernels')."""
    conv, t = ConverterWork(cfg), tiles(cfg)
    h, w = cfg['dataset']['img_hw']
    opt = cfg['opt']
    n_reg = int(opt.get('n_reg_pts', 1024))
    crop = tuple(opt.get('perceptual_crop_hw', (256, 256)))
    lpips = 3 * vgg_ops(VGG, min(crop[0], h), min(crop[1], w))
    ssim = 2 * ssim_ops(h, w)
    hash_dims = conv.hash or (0, 0, 0)
    c = {k: 0 for k in ('k1_ops', 'k1_bytes', 'k2_ops', 'k2_bytes',
                        'k3_ops', 'k3_bytes', 'ops')}
    for p, n in steps:
        parts = {'k1': k1(p, t), 'k2': k2(p, t),
                 'k3': k3_step(n, p, *hash_dims)}
        for name, v in parts.items():
            c[f'{name}_ops'] += v['ops']
            c[f'{name}_bytes'] += v['bytes']
        c['ops'] += (conv.step_ops(n, n_reg) + lpips + ssim
                     + sum(v['ops'] for v in parts.values()))
    return c
