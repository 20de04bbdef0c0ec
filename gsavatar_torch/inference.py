"""Inference scene: render frames of an avatar from its state.

Counterpart of `gsavatar/inference.py:InferenceScene`. The scene is built
from a state (the Gaussian arena and the converter's parameters) and the
subject's metadata, or with `InferenceScene.from_checkpoint` from a
checkpoint of the port's training (`scene.py:Scene.save_checkpoint`),
which it renders at the checkpoint's iteration and SH degree, or with
`InferenceScene.from_smpl_npz` from such a checkpoint and one SMPL npz
(the serving apps' constructor, no dataset needed), and `load_ply` plays
back a 3DGS ply export. `init_state`
makes a state from the port's own seeded initialisation (arena from the
dataset's point cloud, converter weights from a torch.Generator seeded
through numpy); `synthetic_scene` puts the two together for the synthetic
avatar."""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gsavatar_torch.camera.camera import Camera
from gsavatar_torch.config import load_config
from gsavatar_torch.converter_graphs import ConverterGraphs
from gsavatar_torch.core import gaussians as G
from gsavatar_torch.data import base as data_base
from gsavatar_torch.data import load_dataset
from gsavatar_torch.device import resolve_device
from gsavatar_torch.models.converter import build_converter, compute_nr_cache
from gsavatar_torch.ops.rasterizer import RasterizeConfig
from gsavatar_torch.renderer import RenderPackage, render
from gsavatar_torch.smpl.body_model import find_assets
from gsavatar_torch.utils import ply as ply_io


@dataclasses.dataclass
class AvatarState:
    gauss_params: G.GaussianParams
    gauss_aux: G.GaussianAux
    converter: Dict[str, torch.Tensor]  # GaussianConverter state dict


def torch_generator(seed: int) -> torch.Generator:
    """A CPU generator whose seed numpy derives from `seed`."""
    state = np.random.SeedSequence(seed).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def init_state(cfg: dict, dataset, seed: int = 0,
               device=None) -> AvatarState:
    """A fresh avatar: the arena seeded from `dataset.readPointCloud()` and
    converter weights drawn from `torch_generator(seed)`."""
    dev = resolve_device(device)
    g = cfg['model']['gaussian']
    points, colors = dataset.readPointCloud()
    params, aux = G.create_from_pcd(
        points, colors, int(g['capacity']), bool(g['use_sh']),
        int(g['sh_degree']), int(g.get('feature_dim', 32)), device=dev)
    converter = build_converter(cfg, dataset.metadata, dataset.assets,
                                generator=torch_generator(seed))
    return AvatarState(params, aux, converter.state_dict())


def metadata_from_smpl_npz(npz_path: Optional[str], assets,
                           padding=0.1) -> dict:
    """Canonical metadata from one ZJU-format model npz (its
    `minimal_shape`, through `fix_symmetry`), or from the template when
    there is no npz; `cameras_extent` is ZJU-MoCap's and `frame_dict` is
    left to the checkpoint (`gsavatar/inference.py:26-37`)."""
    if npz_path and os.path.exists(npz_path):
        minimal_shape = data_base.fix_symmetry(
            np.load(npz_path)['minimal_shape'])
    else:
        minimal_shape = assets.v_template.copy()
    md = data_base.canonicalize(minimal_shape, assets, padding=padding)
    md['cameras_extent'] = data_base.ZJU_CAMERAS_EXTENT
    md['frame_dict'] = None
    return md


# the pose correction's per-frame tables and the metadata keys they start
# from (`models/pose_correction.py:get_pose_correction`)
POSE_TABLES = {'pose_correction.root_orients': 'root_orient',
               'pose_correction.pose_bodys': 'pose_body',
               'pose_correction.pose_hands': 'pose_hand',
               'pose_correction.trans': 'trans',
               'pose_correction.betas': 'betas'}


def checkpoint_frame_metadata(converter: Dict[str, torch.Tensor]) -> dict:
    """What a converter built from single-npz metadata needs to take a
    checkpoint's weights: `frame_dict` with one row per texture latent
    (1 without one), as the JAX package sizes it
    (`gsavatar/inference.py:85-91`), and the pose correction's tables as
    the checkpoint holds them, so that each has the checkpoint's rows."""
    latent = converter.get('texture.latent.weight')
    n = latent.shape[0] if latent is not None else 1
    md = {'frame_dict': {i: i for i in range(n)}}
    for key, name in POSE_TABLES.items():
        if key in converter:
            md[name] = converter[key].detach().cpu().numpy()
    return md


def _fit_latent_tables(converter: torch.nn.Module,
                       state: Dict[str, torch.Tensor]) -> None:
    """Give each per-frame latent table of `converter` the rows of the
    checkpoint's (the non-rigid deformer's keeps its own count where the
    texture's sizes `frame_dict`)."""
    for name, module in converter.named_modules():
        key = f'{name}.latent.weight'
        table = getattr(module, 'latent', None)
        if isinstance(table, torch.nn.Embedding) and key in state \
                and state[key].shape != table.weight.shape:
            module.latent = torch.nn.Embedding(*state[key].shape)


def raster_config_from(cfg: dict) -> RasterizeConfig:
    h, w = cfg['dataset']['img_hw']
    r = cfg['rasterizer']
    return RasterizeConfig(width=int(w), height=int(h),
                           max_pairs=int(r['max_pairs']),
                           max_rect=int(r['max_rect']))


class InferenceScene:
    def __init__(self, cfg: dict, metadata: dict, assets, state: AvatarState,
                 device=None, iteration: Optional[int] = None):
        """Renders at `iteration` (default the config's last training
        iteration) with the SH degree of that iteration; without one, at
        the full degree."""
        self.cfg = cfg
        self.device = resolve_device(device)
        gcfg = cfg['model']['gaussian']
        self.use_sh = bool(gcfg['use_sh'])
        self.max_sh_degree = int(gcfg['sh_degree'])
        self.iteration = iteration if iteration is not None \
            else int(cfg['opt']['iterations'])
        self.active_sh_degree = (
            0 if not self.use_sh else self.max_sh_degree if iteration is None
            else min(iteration // 1000, self.max_sh_degree))
        self.raster_config = raster_config_from(cfg)
        white = cfg['dataset'].get('white_background', False)
        self.background = torch.full((3,), 1.0 if white else 0.0,
                                     device=self.device)
        self.metadata = dict(metadata)
        self.assets = assets
        self.converter = build_converter(cfg, metadata, assets)
        _fit_latent_tables(self.converter, state.converter)
        self.converter.load_state_dict(state.converter)
        self.converter.to(self.device).eval()
        self.converter_graphs = ConverterGraphs(self.converter)
        self._set_arena(state.gauss_params, state.gauss_aux)

    def _set_arena(self, params: G.GaussianParams, aux: G.GaussianAux):
        self.gauss_params = params.map(lambda x: x.to(self.device))
        self.gauss_aux = aux.map(lambda x: x.to(self.device))
        # render only the alive prefix when the alive slots form one
        alive = self.gauss_aux.alive.cpu()
        n_alive = int(alive.sum())
        self.bucket = n_alive if bool(alive[:n_alive].all()) else 0
        self._nr_cache = None
        self.converter_graphs.reset(self.converter)

    def load_ply(self, path: str, capacity: Optional[int] = None
                 ) -> "InferenceScene":
        """Static playback of a 3DGS ply export (`utils/ply.py`): its
        Gaussians fill the first slots of an arena of `capacity` (default
        their count), and the converter is built anew for a single frame
        (`frame_dict` {0: 0}) with its initial weights from
        `torch_generator(0)`, as the JAX package's `load_ply` rebuilds
        its converter (a ply carries no converter weights)."""
        data = ply_io.load_gaussian_ply(path, self.max_sh_degree)
        n = data['xyz'].shape[0]
        cap = capacity or n
        params = G.empty_params(
            cap, self.use_sh, self.max_sh_degree,
            int(self.cfg['model']['gaussian'].get('feature_dim', 32)))
        for k, v in data.items():
            getattr(params, k)[:n] = torch.from_numpy(np.array(v))
        aux = G.empty_aux(cap)
        aux.alive[:n] = True
        self.metadata['frame_dict'] = {0: 0}
        self.converter = build_converter(
            self.cfg, self.metadata, self.assets,
            generator=torch_generator(0)).to(self.device).eval()
        self._set_arena(params, aux)
        return self

    @classmethod
    def from_checkpoint(cls, cfg: dict, path: str, device=None
                        ) -> "InferenceScene":
        """The avatar of a training checkpoint, with the metadata of the
        config's subject (the training split of `data.load_dataset`)."""
        from gsavatar_torch.scene import read_checkpoint
        dev = resolve_device(device)
        ckpt = read_checkpoint(path, dev)
        train = load_dataset(cfg['dataset'], 'train')
        state = AvatarState(G.GaussianParams(**ckpt['gauss_params']),
                            G.GaussianAux(**ckpt['gauss_aux']),
                            ckpt['converter'])
        return cls(cfg, train.metadata, train.assets, state, device=dev,
                   iteration=int(ckpt['iteration']))

    @classmethod
    def from_smpl_npz(cls, cfg: dict, checkpoint: str,
                      smpl_npz: Optional[str] = None, assets=None,
                      width: Optional[int] = None,
                      height: Optional[int] = None, device=None
                      ) -> "InferenceScene":
        """The serving apps' scene (`gsavatar/inference.py:40-95`): the
        avatar of a training checkpoint with metadata from one SMPL npz
        (`metadata_from_smpl_npz`; the template without one) and the
        assets of `cfg['body_models_dir']`, rendered at `width` x
        `height` (default the config's `img_hw`) on black, at the
        config's last iteration with the full SH degree. Every per-frame
        table takes the checkpoint's rows; a live camera reads row 0 and
        blends none of it in (`in_frame_dict` 0)."""
        from gsavatar_torch.scene import read_checkpoint
        dev = resolve_device(device)
        ckpt = read_checkpoint(checkpoint, dev)
        assets = assets or find_assets(cfg.get('body_models_dir'))
        md = metadata_from_smpl_npz(smpl_npz, assets)
        md.update(checkpoint_frame_metadata(ckpt['converter']))
        cfg = copy.deepcopy(cfg)
        h, w = cfg['dataset']['img_hw']
        cfg['dataset']['img_hw'] = [int(height or h), int(width or w)]
        cfg['dataset']['white_background'] = False
        state = AvatarState(G.GaussianParams(**ckpt['gauss_params']),
                            G.GaussianAux(**ckpt['gauss_aux']),
                            ckpt['converter'])
        return cls(cfg, md, assets, state, device=dev)

    def view(self) -> G.Gaussians:
        return G.make_view(
            self.gauss_params, self.gauss_aux,
            active_sh_degree=self.active_sh_degree,
            max_sh_degree=self.max_sh_degree, use_sh=self.use_sh,
            bucket=self.bucket)

    @torch.inference_mode()
    def render_frame(self, camera, iteration: Optional[int] = None
                     ) -> RenderPackage:
        """Render one camera (its tensors on this scene's device) at
        `iteration`, by default the scene's. On the GPU the converter runs
        as a CUDA graph from the second frame of a key on
        (`converter_graphs.py`)."""
        it = iteration if iteration is not None else self.iteration
        gview = self.view()
        if self._nr_cache is None:
            # canonical positions are frozen at inference: encode once
            self._nr_cache = compute_nr_cache(self.converter, gview)
        return render(self.converter_graphs, gview, camera, it,
                      self.raster_config, self.background,
                      nr_cache=self._nr_cache)


def synthetic_scene(overrides: Sequence[str] = (), seed: int = 0,
                    device=None) -> Tuple[InferenceScene, List[Camera]]:
    """The synthetic avatar (config defaults plus dotted `overrides`) with
    weights from `init_state(seed)`, and the cameras of its predict split.
    The state is made on the CPU and then moved, so that two scenes of one
    seed on two devices hold the same values."""
    cfg = load_config(overrides)
    train = load_dataset(cfg['dataset'], 'train')
    predict = load_dataset(cfg['dataset'], 'predict', ground_truth=False)
    state = init_state(cfg, train, seed=seed, device='cpu')
    scene = InferenceScene(cfg, train.metadata, train.assets, state,
                           device=device)
    return scene, [predict[i] for i in range(len(predict))]
