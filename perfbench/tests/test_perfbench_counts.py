"""The operation and byte counts against hand counts at tiny sizes, and
the converter's counts, for every combination of the port's config groups,
against the reference modules' own layers and the products of their
forward."""
import itertools
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gsavatar_torch.config import GROUPS, load_config
from perfbench.harness import counts
from perfbench.harness.registry import HERE
from perfbench.tests.tiny import TINY_DATASET


def test_dense_and_compositor_counts():
    # 4 -> 3 -> 2: (4*3 + 3*2) multiply-adds a row
    assert counts.dense_ops([(4, 3), (3, 2)]) == 2 * (12 + 6)
    # xyz encoded at one frequency, 3 * (1 + 2) = 9 wide; a condition of 5
    # at layer 0; a skip at layer 2, so layer 1 gives up 9 of its 16
    assert counts.mlp_layers(3, 5, 2, {
        'n_neurons': 16, 'n_hidden_layers': 3, 'skip_in': [2],
        'cond_in': [0], 'multires': 1}) == [(14, 16), (16, 7), (16, 16),
                                            (16, 2)]
    # the Hann-window encoding has no identity part: 3 * 2 = 6 wide
    assert counts.mlp_layers(3, 0, 2, {'n_neurons': 4, 'n_hidden_layers': 1,
                                       'multires': 1}, hannw=True) == \
        [(6, 4), (4, 2)]
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


def _choices():
    """Every combination of the port's config groups that the converter
    reads, the skinning field also distilled: (pose_correction, non_rigid,
    rigid, texture)."""
    rigid = sorted(GROUPS['rigid']) + ['skinning_field+distill']
    return list(itertools.product(sorted(GROUPS['pose_correction']),
                                  sorted(GROUPS['non_rigid']), rigid,
                                  sorted(GROUPS['texture'])))


def _refused(choice) -> bool:
    """A texture that takes a non-rigid feature, after a deformer that
    gives none."""
    _, nr, _, tex = choice
    return tex != 'sh' and nr in ('identity', 'hannw_mlp')


# the texture MLP's optional inputs, each alone and all three
_TEX_FLAGS = [('use_xyz',), ('use_cov',), ('use_normal',),
              ('use_xyz', 'use_cov', 'use_normal')]
ACCEPTED = (['zju377_full.train', 'ps_female3_rigid.serve']
            + [c for c in _choices() if not _refused(c)]
            + [('direct', 'mlp', 'skinning_field', tex, flags)
               for tex in ('mlp', 'shallow_mlp') for flags in _TEX_FLAGS])


def _case_id(case):
    if isinstance(case, str):
        return case
    return '-'.join(case[:4]) + ''.join(f'+{f}' for f in
                                         (case[4] if len(case) > 4 else ()))


def _config(case) -> dict:
    """The configuration of a workload cut to its tiny size, or of a
    combination of the groups at their published widths over the tiny
    synthetic subject."""
    if isinstance(case, str):
        from perfbench.tests.tiny import tiny_cell
        return tiny_cell(case).config['config']
    pc, nr, rg, tex = case[:4]
    rg, _, distill = rg.partition('+')
    over = [f'pose_correction={pc}', f'non_rigid={nr}', f'rigid={rg}',
            f'texture={tex}']
    if distill:
        over.append('model.deformer.rigid.distill=true')
    over += [f'model.texture.{f}=true' for f in
             (case[4] if len(case) > 4 else ())]
    cfg = load_config(over)
    cfg['dataset'].update(TINY_DATASET)
    return cfg


def _reference(cfg):
    from perfbench.reference.plain.data.synthetic import SyntheticDataset
    from perfbench.reference.plain.models.converter import build_converter
    ds = SyntheticDataset(cfg['dataset'], 'train')
    conv = build_converter(cfg, ds.metadata, ds.assets,
                           generator=torch.Generator().manual_seed(0))
    return ds, conv


def _forward(cfg, ds, conv, n: int) -> int:
    """One eval forward of the reference converter over n Gaussians: the
    products torch's flop counter sees in it."""
    from perfbench.reference.plain.core import gaussians as G
    g = cfg['model']['gaussian']
    gen = torch.Generator().manual_seed(n)
    pts = torch.rand(n, 3, generator=gen) - 0.5
    params, aux = G.create_from_pcd(
        pts.numpy(), torch.rand(n, 3, generator=gen).numpy(), n,
        bool(g['use_sh']), int(g['sh_degree']),
        int(g.get('feature_dim', 32)))
    view = G.make_view(params, aux, max_sh_degree=int(g['sh_degree']),
                       active_sh_degree=int(g['sh_degree']) * g['use_sh'],
                       use_sh=bool(g['use_sh']))
    cam = ds._camera(0)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        conv(view, cam, int(cfg['opt']['iterations']))
    return fc.get_total_flops()


def _layers(conv, prefix=''):
    """2 fan_in fan_out over the module's dense layers."""
    return sum(2 * p.shape[0] * p.shape[1] for name, p in
               conv.named_parameters() if name.startswith(prefix)
               and p.ndim == 2 and 'pose_encoder' not in name
               and 'latent' not in name and 'pose_correction' not in name)


@pytest.mark.parametrize('case', ACCEPTED, ids=_case_id)
def test_converter_widths_are_the_reference_modules(case):
    cfg = _config(case)
    work = counts.ConverterWork(cfg)
    ds, conv = _reference(cfg)
    rigid = cfg['model']['deformer']['rigid']
    distill = rigid['name'] == 'skinning_field' and rigid.get('distill')
    field = _layers(conv, 'rigid.lbs_network')
    # the per-Gaussian MLPs; the pose encoder runs once a frame, and the
    # distilled field's MLP over its voxel's cells
    assert work.dense == _layers(conv) - distill * field
    res = int(rigid.get('res', 64))
    assert work.voxel == distill * field * (
        res // int(rigid.get('z_ratio', 4))) * res * res
    blend = counts.BLEND_OPS * (rigid['name'] != 'identity')
    sample = counts.hashgrid_ops(1, 1, counts.BONES) * bool(distill)
    tex = cfg['model']['texture']['name']
    sh = 2 * 3 * 16 if tex == 'sh2rgb' else 0
    assert work.per_point == work.dense + blend + sample + sh
    n_verts = int(cfg['dataset']['n_verts'])
    assert work.search == 9 * n_verts * (rigid['name'] == 'smpl_nn')
    assert work.frame_ops(10) == 10 * (work.per_point + work.search)
    skin_row = sample if distill else field
    hash_reads = 2 * counts.hashgrid_ops(10, 16, 2) if work.hash else 0
    assert work.step_ops(10, 4) == 3 * (work.per_point * 10 + work.voxel
                                        + skin_row * 4) \
        + work.search * 10 + hash_reads


@pytest.mark.parametrize('case', ACCEPTED, ids=_case_id)
def test_converter_dense_work_is_the_reference_forwards_flops(case):
    """The products torch's flop counter sees in one eval forward of the
    reference converter, on N and on 2N Gaussians: per Gaussian, the dense
    layers, the blend's (24 -> 16) product, and the nearest-vertex
    search's cross term (2 * 3 a template vertex) as `nn_index` computes
    it. The rest (pose encoder and correction, a distilled voxel) does not
    grow with N."""
    cfg = _config(case)
    work = counts.ConverterWork(cfg)
    ds, conv = _reference(cfg)
    flops = [_forward(cfg, ds, conv, n) for n in (64, 128)]
    rigid = cfg['model']['deformer']['rigid']['name']
    blend = 2 * counts.BONES * 16 * (rigid != 'identity')
    cross = 2 * 3 * int(cfg['dataset']['n_verts']) * (rigid == 'smpl_nn')
    assert (flops[1] - flops[0]) // 64 == work.dense + blend + cross
    assert (flops[1] - flops[0]) % 64 == 0


# a name no config group has, in place of each group's choice
UNKNOWN = ['pose_correction=posenet', 'non_rigid=bspline', 'rigid=lbs_grid',
           'texture=neural_sh']
REFUSED = [c for c in _choices() if _refused(c)] + UNKNOWN


def _refused_config(case) -> dict:
    if isinstance(case, tuple):
        return _config(case)
    group, name = case.split('=')
    cfg = _config(('direct', 'mlp', 'skinning_field', 'mlp'))
    m = cfg['model']
    node = m[group] if group in m else m['deformer'][group]
    node['name'] = name
    return cfg


@pytest.mark.parametrize('case', REFUSED, ids=_case_id)
def test_a_configuration_the_converter_refuses_is_refused_alike(case):
    """The reference's converter raises at its build (an unknown name) or
    at its first forward (a texture's non-rigid feature that the deformer
    does not give); `ConverterWork` raises the same ValueError."""
    cfg = _refused_config(case)
    with pytest.raises(ValueError) as ours:
        counts.ConverterWork(cfg)
    with pytest.raises(ValueError) as ref:
        ds, conv = _reference(cfg)
        _forward(cfg, ds, conv, 8)
    assert str(ours.value) == str(ref.value)


def test_every_combination_is_counted_or_refused():
    assert len(_choices()) == 2 * 4 * 4 * 3
    assert sum(map(_refused, _choices())) == 2 * 2 * 4 * 2


# the parent's integers on fixed pair lists, from the two accepted
# configurations: the counting code moved, the counts did not
SERVE_PAIRS = [1234567, 987654, 1500000]
TRAIN_PAIRS = [(1234567, 49152), (1100000, 53248), (998877, 53248)]
PINNED = {
    'zju377_full': {'per_point': 242200, 'hash': (16, 2, 65536),
                    'frame_ops': 12110000000, 'step_ops': 36125933568,
                    'serve': {'k1_ops': 15246217216, 'k1_bytes': 149740896,
                              'ops': 51576217216},
                    'train': {'k1_ops': 13653786624, 'k1_bytes': 135744924,
                              'k2_ops': 13653786624, 'k2_bytes': 271477548,
                              'k3_ops': 83855204, 'k3_bytes': 482874016,
                              'ops': 503576725348}},
    'ps_female3_rigid': {'per_point': 106360, 'hash': None,
                         'frame_ops': 5318000000, 'step_ops': 16007430144,
                         'serve': {'k1_ops': 15246217216,
                                   'k1_bytes': 151770000,
                                   'ops': 31200217216},
                         'train': {'k1_ops': 13653786624,
                                   'k1_bytes': 137774028,
                                   'k2_ops': 13653786624,
                                   'k2_bytes': 275534172,
                                   'k3_ops': 44009316, 'k3_bytes': 218632864,
                                   'ops': 439944931044}},
}


@pytest.mark.parametrize('name', sorted(PINNED))
def test_the_accepted_configurations_count_as_before(name):
    with open(HERE / 'configs' / f'{name}.json') as f:
        cfg = json.load(f)['config']
    want = PINNED[name]
    work = counts.ConverterWork(cfg)
    assert (work.per_point, work.hash) == (want['per_point'], want['hash'])
    assert work.frame_ops(50000) == want['frame_ops']
    assert work.step_ops(49152, 1024) == want['step_ops']
    assert counts.frame_counts(cfg, SERVE_PAIRS, 50000) == want['serve']
    assert counts.step_counts(cfg, TRAIN_PAIRS) == want['train']
