"""The operation and byte counts against hand counts at tiny sizes, and
the converter's widths against the reference modules' own layers."""
import pytest
import torch

from perfbench.harness import counts


def test_dense_and_compositor_counts():
    # 4 -> 3 -> 2 over 5 rows: (4*3 + 3*2) multiply-adds a row
    assert counts.mlp_ops([4, 3, 2], 5) == 2 * (12 + 6) * 5
    # 2 pairs over 3 tiles: 16 operations at 256 pixels a pair; bytes: 9
    # live columns a pair, 4 tile bounds, 5 output rows of 256 a tile
    assert counts.k1(2, 3) == {'ops': 2 * 256 * 16,
                               'bytes': 4 * (2 * 9 + 4 + 3 * 5 * 256)}
    assert counts.k2(2, 3) == {'ops': 2 * 256 * 16,
                               'bytes': 4 * (2 * 2 * 9 + 4
                                             + 2 * 3 * 5 * 256)}
    assert counts.segsum(10, 3, 4) == {'ops': 30,
                                       'bytes': 4 * (10 * 4 + 4 * 3)}


def test_k3_step_is_its_launches():
    one = counts.k3_step(4, 6)
    parts = [counts.segsum(6, 9, 4)] + [counts.segsum(20, c, 4)
                                        for c in (3, 3, 6, 6)]
    assert one['ops'] == sum(p['ops'] for p in parts)
    assert one['bytes'] == sum(p['bytes'] for p in parts)
    hashed = counts.k3_step(4, 6, 2, 2, 8)
    table = counts.segsum(4 * 2 * 8, 2, 16)
    assert hashed['bytes'] == one['bytes'] + table['bytes']


def test_vgg_and_ssim_by_hand():
    stages = [{'pool': None, 'convs': [(2, 3, 1, 1)]},
              {'pool': (2, 2), 'convs': [(4, 3, 1, 1)]}]
    # 8x8: 3 -> 2 channels at 8x8, pool to 4x4, 2 -> 4 channels
    assert counts.vgg_ops(stages, 8, 8) == \
        2 * 64 * 3 * 2 * 9 + 2 * 16 * 2 * 4 * 9
    assert counts.ssim_ops(4, 5) == 5 * 2 * 2 * 11 * 3 * 20


@pytest.mark.parametrize('workload', ['zju377_full.train',
                                      'ps_female3_rigid.serve'])
def test_converter_widths_are_the_reference_modules(workload):
    from perfbench.reference.plain.data.synthetic import SyntheticDataset
    from perfbench.reference.plain.models.converter import build_converter
    from perfbench.tests.tiny import tiny_cell
    cfg = tiny_cell(workload).config['config']
    work = counts.ConverterWork(cfg)
    ds = SyntheticDataset(cfg['dataset'], 'train')
    conv = build_converter(cfg, ds.metadata, ds.assets,
                           generator=torch.Generator().manual_seed(0))
    per_point = 0
    for name, p in conv.named_parameters():
        # the per-Gaussian MLPs; the pose encoder runs once a frame
        if p.ndim == 2 and 'pose_encoder' not in name \
                and 'latent' not in name and 'pose_correction' not in name:
            per_point += 2 * p.shape[0] * p.shape[1]
    tex = cfg['model']['texture']['name']
    blend = 2 * counts.BONES * 16 + 2 * 12
    sh = 2 * 3 * 16 if tex == 'sh2rgb' else 0
    assert work.per_point == per_point + blend + sh
    assert work.frame_ops(10) == 10 * work.per_point
    hash_reads = 2 * counts.hashgrid_ops(10, 16, 2) if work.hash else 0
    assert work.step_ops(10, 4) == 3 * work.per_point * 10 + 3 * \
        counts.mlp_ops(work.skin_dims, 4) + hash_reads
