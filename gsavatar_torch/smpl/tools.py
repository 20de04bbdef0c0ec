"""SMPL asset tooling.

Counterpart of `gsavatar/smpl/tools.py`:
- `extract_smpl_parameters` converts raw SMPL `.pkl` model files into the
  `body_models/misc/*.npz` bundles that `body_model.load_assets` reads
  (the same files, keys and dtypes; sparse matrices made dense);
- `vitruvian_verts` gives the star-pose vertices of a rest shape, in
  torch;
- `plot_smpl` draws vertices and joints with matplotlib's Agg backend.

`pickle` and matplotlib are imported inside the functions that use them;
without matplotlib, `plot_smpl` raises an ImportError that names it."""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from gsavatar_torch.device import resolve_device
from .body_model import SMPLAssets
from .vitruvian import get_02v_bone_transforms_torch

GENDERS = ("male", "female", "neutral")


def extract_smpl_parameters(pkl_paths: Dict[str, str],
                            out_dir: str = "body_models/misc") -> str:
    """`pkl_paths`: gender -> path of the raw SMPL model pickle. Writes
    J_regressors, skinning_weights_all, posedirs_all, shapedirs_all (the
    first 10 shape directions) and v_templates npz files keyed by gender,
    faces.npz and kintree_table.npy (of the last gender) into `out_dir`."""
    import pickle
    os.makedirs(out_dir, exist_ok=True)
    bundles: Dict[str, dict] = {k: {} for k in
                                ('J_regressors', 'skinning_weights_all',
                                 'posedirs_all', 'shapedirs_all',
                                 'v_templates')}
    faces = None
    kintree = None
    for gender, path in pkl_paths.items():
        with open(path, 'rb') as f:
            data = pickle.load(f, encoding='latin1')

        def arr(x):
            return np.asarray(x.todense() if hasattr(x, 'todense') else x)

        bundles['J_regressors'][gender] = \
            arr(data['J_regressor']).astype(np.float64)
        bundles['skinning_weights_all'][gender] = arr(data['weights'])
        bundles['posedirs_all'][gender] = arr(data['posedirs'])
        bundles['shapedirs_all'][gender] = arr(data['shapedirs'])[..., :10]
        bundles['v_templates'][gender] = arr(data['v_template'])
        faces = arr(data['f']).astype(np.int64)
        kintree = arr(data['kintree_table']).astype(np.int64)

    for name, d in bundles.items():
        np.savez(os.path.join(out_dir, f"{name}.npz"), **d)
    np.savez(os.path.join(out_dir, "faces.npz"), faces=faces)
    np.save(os.path.join(out_dir, "kintree_table.npy"), kintree)
    return out_dir


def vitruvian_verts(assets: SMPLAssets, minimal_shape=None,
                    device=None) -> torch.Tensor:
    """(V, 3) float32 star-pose vertices of a rest shape (the template
    when `minimal_shape` is None) on `device`: the rest joints' 02v bone
    transforms blended by the skinning weights and applied to each
    vertex."""
    device = resolve_device(device)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    shape = t(assets.v_template if minimal_shape is None else minimal_shape)
    Jtr = t(assets.J_regressor) @ shape
    tf = get_02v_bone_transforms_torch(Jtr)
    T = (t(assets.skinning_weights) @ tf.reshape(-1, 16)).reshape(-1, 4, 4)
    return (T[:, :3, :3] @ shape[..., None])[..., 0] + T[:, :3, 3]


def plot_smpl(verts, faces: Optional[np.ndarray] = None,
              joints=None, out_path: Optional[str] = None):
    """A matplotlib 3D scatter of the vertices (and the joints in red),
    headless; saved at 100 dpi to `out_path` (returned), else the figure
    is returned."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_smpl needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    verts = np.asarray(torch.as_tensor(verts).cpu())
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection='3d')
    ax.scatter(verts[:, 0], verts[:, 1], verts[:, 2], s=0.3, alpha=0.4)
    if joints is not None:
        joints = np.asarray(torch.as_tensor(joints).cpu())
        ax.scatter(joints[:, 0], joints[:, 1], joints[:, 2], s=25, c='r')
    ax.set_box_aspect((np.ptp(verts[:, 0]), np.ptp(verts[:, 1]),
                       np.ptp(verts[:, 2])))
    if out_path:
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
        return out_path
    return fig
