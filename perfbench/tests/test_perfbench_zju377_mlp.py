"""The MLP avatar's cell, `zju377_mlp.serve`: the harness finds its
configuration, traffic, limits and readers by name; the configuration file
holds what `load_config` composes from its overrides, at the published
widths; the cell runs at a tiny size on the CPU and comes out correct; and
the readers of the converter's stage spans give each span's host ms a
frame, or None where the span did not run."""
import pytest

from gsavatar_torch.config import load_config
from perfbench.harness import check, registry, trace

CELL = 'zju377_mlp.serve'
READERS = {'nonrigid_mlp_ms.serve': 'non_rigid/mlp',
           'pose_code_ms.serve': 'non_rigid/pose_code',
           'texture_mlp_ms.serve': 'texture/mlp'}


def test_the_cell_resolves():
    cell = registry.cell(CELL)
    assert (cell.config_name, cell.traffic_name, cell.chips) == \
        ('zju377_mlp', 'playback', 1)
    assert cell.traffic['driver'] == 'playback'
    assert set(cell.limits) == {'pose_gap', 'xyz_gap', 'color_gap',
                                'image_mae', 'alpha_mae'}
    assert {m['name'] for m in cell.end_to_end} == {'serve_frame_p95_ms',
                                                    'setup_s'}
    names = {m['name'] for m in cell.per_layer}
    assert set(READERS) <= names
    # every serve metric of the hash-grid cell but none that reads it alone
    zju = {m['name'] for m in registry.cell('zju377_full.serve').per_layer}
    assert names == zju | {'nonrigid_mlp_ms.serve'}
    assert all(callable(registry.reader(n)) for n in names)


def test_the_file_holds_what_load_config_composes():
    conf = registry.cell(CELL).config
    assert conf['config'] == load_config(conf['overrides'])
    assert conf['groups'] == {'pose_correction': 'direct',
                              'non_rigid': 'mlp', 'rigid': 'skinning_field',
                              'texture': 'mlp', 'option': 'iter15k'}
    m = conf['config']['model']
    nr = m['deformer']['non_rigid']
    assert nr['mlp'] == {'n_neurons': 256, 'n_hidden_layers': 8,
                         'skip_in': [4], 'cond_in': [0], 'multires': 6,
                         'last_layer_init': False}
    assert (nr['feature_dim'], nr['latent_dim'], nr['delay']) == (64, 0, 3000)
    assert nr['pose_encoder']['num_joints'] * \
        nr['pose_encoder']['dim_per_joint'] == 144
    tex = m['texture']
    assert (tex['mlp']['n_neurons'], tex['mlp']['n_hidden_layers']) == \
        (256, 4)
    assert (tex['feature_dim'], tex['non_rigid_dim'], tex['latent_dim'],
            tex['sh_degree']) == (128, 64, 64, 3)
    assert list(conf['reduced']) == ['dataset']
    assert conf['config']['dataset']['n_points'] == 50000
    assert conf['config']['dataset']['img_hw'] == [512, 512]


def test_the_tiny_cell_is_correct_on_the_cpu():
    from perfbench.tests.tiny import run_tiny
    cell, out = run_tiny(CELL, seed=2147483921, seconds=0.5)
    ok, checks = check.judge(out['readings'], cell.limits)
    assert ok, checks
    assert out['attempted'] > 0 and out['metrics']['serve_frame_p95_ms'] > 0


# two traced frames over 100 us; each span twice
SPANS = [('non_rigid/pose_code', 0, 2), ('non_rigid/pose_code', 50, 51),
         ('non_rigid/mlp', 2, 8), ('non_rigid/mlp', 51, 55),
         ('texture/mlp', 10, 13), ('texture/mlp', 60, 61)]
WANT = {'nonrigid_mlp_ms.serve': 0.005, 'pose_code_ms.serve': 0.0015,
        'texture_mlp_ms.serve': 0.002}


def _traced(spans):
    return trace.from_events([('composite_fwd_kernel', 0, 10)], spans,
                             100e-6, 2, {}, {})


@pytest.mark.parametrize('metric', sorted(READERS))
def test_a_reader_gives_its_spans_ms_a_frame(metric):
    assert registry.reader(metric)(_traced(SPANS)) == \
        pytest.approx(WANT[metric])
    # the span alone is read, not its neighbours
    alone = [s for s in SPANS if s[0] == READERS[metric]]
    assert registry.reader(metric)(_traced(alone)) == \
        pytest.approx(WANT[metric])


@pytest.mark.parametrize('metric', sorted(READERS))
def test_a_reader_is_none_where_its_span_did_not_run(metric):
    # the parent program has the converter's stages but not these spans
    spans = [('converter/non_rigid', 0, 8), ('converter/texture', 10, 13)]
    assert registry.reader(metric)(_traced(spans)) is None
