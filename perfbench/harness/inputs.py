"""The inputs a cell hands to the program and to the reference alike, made
from the seed: the weights, and the playback motion.

The weights start from the reference's own initialisation (its converter
from a CPU generator seeded from the seed, its arena seeded from the
synthetic point cloud) and take one draw of normal noise made on the card
in one call, scaled per leaf, so that no value is one the program made."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

# the noise on each arena field (xyz in metres, log-scales, quaternions,
# opacity logits, colour features)
ARENA_NOISE = {'xyz': 0.002, 'features_dc': 0.2, 'features_rest': 0.2,
               'scaling': 0.2, 'rotation': 0.1, 'opacity': 1.0}
# the opacity logits of the state at the start iteration centre here
# (opacity 0.88), not at the initial 0.1: thousands of iterations in,
# pruning has taken the transparent splats, and a round prunes few
OPACITY_LOGIT = 2.0
# the noise on a converter leaf: a tenth of its RMS, at least this
CONVERTER_NOISE_FLOOR = 0.01
# the widest splat of the state at the start iteration (m): the synthetic
# point cloud's sparse outliers start at up to 0.11 m, wider than anything
# densify and pruning leave after thousands of iterations
MAX_SCALE = 0.03


def cpu_generator(seed: int) -> torch.Generator:
    """A CPU generator whose seed numpy derives from `seed` (the port's
    `inference.torch_generator` recipe)."""
    state = np.random.SeedSequence(seed).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def derived_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class Weights:
    subject: object                  # the reference's synthetic subject
    conv: Dict[str, torch.Tensor]    # converter state dict, on the device
    trained: list                    # the names of its parameters
    arena: Dict[str, torch.Tensor]   # the six arena fields, capacity rows
    alive: torch.Tensor              # (capacity,) bool


def make_weights(cfg: dict, seed: int, device, opacity_noise: float = None,
                 max_scale: float = None) -> Weights:
    """The seed's weights; a traffic mix may widen the opacity logits'
    noise and the cap on the splats' size (the same draw, scaled)."""
    from perfbench.reference.plain.core import gaussians as G
    from perfbench.reference.plain.data.synthetic import SyntheticDataset
    from perfbench.reference.plain.models.converter import build_converter
    subject = SyntheticDataset(cfg['dataset'], 'train')
    module = build_converter(cfg, subject.metadata, subject.assets,
                             generator=cpu_generator(seed))
    leaves = [k for k, _ in module.named_parameters()]
    conv = module.state_dict()
    g = cfg['model']['gaussian']
    points, colors = subject.readPointCloud()
    params, aux = G.create_from_pcd(
        points, colors, int(g['capacity']), bool(g['use_sh']),
        int(g['sh_degree']), int(g.get('feature_dim', 32)), device=device)
    n = points.shape[0]
    scales = {k: max(0.1 * float(conv[k].pow(2).mean().sqrt()),
                     CONVERTER_NOISE_FLOOR) for k in leaves}
    conv = {k: v.to(device) for k, v in conv.items()}
    arena = {f: getattr(params, f) for f in ARENA_NOISE}
    arena_noise = dict(ARENA_NOISE)
    if opacity_noise is not None:
        arena_noise['opacity'] = float(opacity_noise)
    sizes = [conv[k].numel() for k in leaves] + \
        [arena[f][:n].numel() for f in ARENA_NOISE]
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 1))
    noise = torch.randn(sum(sizes), generator=gen, device=device)
    parts = iter(torch.split(noise, sizes))
    with torch.no_grad():
        arena['opacity'][:n] = OPACITY_LOGIT
        for k in leaves:
            conv[k].add_(scales[k] * next(parts).view_as(conv[k]))
        for f, scale in arena_noise.items():
            arena[f][:n].add_(scale * next(parts).view_as(arena[f][:n]))
        arena['scaling'][:n].clamp_(max=float(np.log(max_scale or MAX_SCALE)))
    return Weights(subject, conv, leaves, arena, aux.alive)


def motion(traffic: dict, seed: int) -> Dict[str, np.ndarray]:
    """A CLIFF-style motion of `motion_frames` frames: each body joint's
    three axis-angle components swing as sines whose amplitudes, cycles
    over the motion and phases are drawn from the seed; the root, the
    hands, the shape and the translation stay zero."""
    rng = np.random.default_rng(derived_seed(seed, 2))
    f = int(traffic['motion_frames'])
    amp = rng.uniform(*traffic['amplitude'], size=(21, 3))
    cycles = rng.uniform(*traffic['cycles'], size=(21, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(21, 3))
    t = np.arange(f)[:, None, None] / f
    body = amp * np.sin(2 * np.pi * cycles * t + phase)
    pose = np.zeros((f, 72), np.float32)
    pose[:, 3:66] = body.reshape(f, 63)
    return {'pose': pose, 'shape': np.zeros((f, 10), np.float32),
            'global_t': np.zeros((f, 3), np.float32)}
