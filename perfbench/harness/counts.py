"""The work the algorithm needs, counted from shapes and pair counts: f32
operations (a multiply-add is two) and HBM bytes (each input byte read
once, each output byte written once). What a particular kernel does more
(a pair walked twice, a row re-read) is not counted, so a later PR that
fuses or replaces a kernel leaves every count as it is.

Counts are per frame or per training step; the drivers add them up over
a traced slice under the keys the metric readers read."""
from __future__ import annotations

from typing import Dict, Sequence

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


def mlp_ops(dims: Sequence[int], rows: int) -> int:
    """One forward pass of a dense MLP with layer widths dims[0] -> ... ->
    dims[-1] over `rows` rows (biases and activations left out)."""
    return sum(2 * a * b for a, b in zip(dims, dims[1:])) * rows


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


class ConverterWork:
    """The converter's f32 operations per Gaussian (and per frame) for one
    configuration, from its widths: the non-rigid MLP on the hash-grid
    encoding and the pose code, the skinning field's MLP with its blend of
    24 bone transforms, and the texture (an MLP, or SH evaluation)."""

    def __init__(self, cfg: dict):
        m = cfg['model']
        nr = m['deformer']['non_rigid']
        self.hash = None
        self.per_point = 0
        if nr['name'] == 'hashgrid':
            hg, pe, mlp = nr['hashgrid'], nr['pose_encoder'], nr['mlp']
            self.hash = (int(hg['n_levels']), int(hg['n_features_per_level']),
                         1 << int(hg['log2_hashmap_size']))
            enc = self.hash[0] * self.hash[1]
            pose = int(pe['num_joints']) * int(pe['dim_per_joint'])
            out = 3 + 3 + 4 + int(nr['feature_dim'])
            self.per_point += mlp_ops(
                [enc + pose] + [int(mlp['n_neurons'])]
                * int(mlp['n_hidden_layers']) + [out], 1)
        elif nr['name'] != 'identity':
            raise ValueError(f"no count for non_rigid={nr['name']}")
        rg = m['deformer']['rigid']
        if rg['name'] != 'skinning_field':
            raise ValueError(f"no count for rigid={rg['name']}")
        net = rg['skinning_network']
        self.skin_dims = [3] + [int(net['n_neurons'])] * int(
            net['n_hidden_layers']) + [int(rg['d_out'])]
        # the field, the blend of the bone transforms, the 4x4 transform
        self.per_point += mlp_ops(self.skin_dims, 1) + 2 * BONES * 16 + 2 * 12
        tex = m['texture']
        if tex['name'] == 'mlp':
            feat = int(tex['feature_dim']) - 1
            sh = (int(tex['sh_degree']) + 1) ** 2
            dims = [feat + int(tex['non_rigid_dim']) + int(tex['latent_dim'])
                    + sh] + [int(tex['mlp']['n_neurons'])] * int(
                        tex['mlp']['n_hidden_layers']) + [3]
            self.per_point += mlp_ops(dims, 1)
        elif tex['name'] == 'sh2rgb':
            deg = int(m['gaussian']['sh_degree'])
            self.per_point += 2 * 3 * (deg + 1) ** 2
        else:
            raise ValueError(f"no count for texture={tex['name']}")

    def frame_ops(self, n: int) -> int:
        """A frame at eval: the hash-grid encoding is cached, so no table
        read."""
        return self.per_point * n

    def step_ops(self, n: int, skin_rows: int) -> int:
        """A training step: the forward and the backward (input and weight
        gradients, twice the forward), with the hash-grid reads and their
        transposes, and the skinning loss's field on its minibatch."""
        ops = 3 * self.per_point * n + 3 * mlp_ops(self.skin_dims, skin_rows)
        if self.hash:
            ops += 2 * hashgrid_ops(n, self.hash[0], self.hash[1])
        return ops
