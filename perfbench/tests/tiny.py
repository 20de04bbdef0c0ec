"""A cell cut to a size the CPU runs in seconds (64x64 frames, 768
Gaussians), for the tests that drive the harness on the CPU, where the
program takes its plain paths."""
from __future__ import annotations

from perfbench.harness import registry

TINY_DATASET = {'img_hw': [64, 64], 'n_verts': 512, 'n_points': 768,
                'n_target_gaussians': 768}


def tiny_cell(name: str):
    cell = registry.cell(name)
    cfg = cell.config['config']
    cfg['dataset'].update(TINY_DATASET)
    cfg['dataset']['train_frames'] = [0, 8, 2]
    cfg['model']['gaussian']['capacity'] = 4096
    cfg['opt']['skinning_pool_size'] = 1024
    cfg['opt']['perceptual_crop_hw'] = [32, 32]
    cell.traffic.update(warmup_frames=2, check_within_frames=4,
                        check_frames=2, trace_frames=3, trace_steps=4,
                        settle_rounds=0)
    return cell


def run_tiny(name: str, seed: int = 3, seconds: float = 1.0):
    import torch
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    return cell, registry.driver(cell.traffic).run(cell, seed, seconds,
                                                   False, device='cpu')
