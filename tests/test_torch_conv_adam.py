"""The converter's optimizer step around K5 on the CPU: the in-place
contract of `ConverterOptimizer.step`, the route by device, and the host
side of the kernel (`ops/conv_adam.py`): the block list and group ids of
the zju377_full recipe's converter, zero-size leaves, empty groups, and
which gradient layouts the norm reads. The kernel itself runs only on the
card (tests/test_torch_gpu.py); the plain version's agreement with optax is
held in tests/test_torch_losses.py and tests/torch_variant_case.py."""
import numpy as np
import pytest
import torch

import torch_dist_workers  # noqa: F401  (torch on one thread)
import chip_smoke
from gsavatar_torch.ops import conv_adam
from gsavatar_torch.ops.conv_adam import (CHUNK, MAX_TENSORS, N_ADAM,
                                          N_GROUPS, chunk_blocks,
                                          table_words)
from gsavatar_torch.scene import GROUPS, ConverterOptimizer, param_group

OPT = {'opt': {'lr_ratio': 0.1, 'grad_clip': 0.1, 'rigid_lr': 1e-4,
               'non_rigid_lr': 1e-3, 'nr_latent_lr': 1e-3,
               'pose_correction_lr': 1e-4, 'texture_lr': 1e-3,
               'tex_latent_lr': 1e-3}}
# one leaf of each group but the non-rigid latent one
LEAVES = {'rigid.lbs_network.lin0.weight': (6, 4),
          'non_rigid.hashgrid.table': (3, 8, 2),
          'texture.latent.weight': (2, 16),
          'texture.mlp.lin0.bias': (5,),
          'pose_correction.betas': (1, 10)}


@pytest.fixture(scope='module')
def zju():
    return chip_smoke.zju_converter_leaves()


def _leaves(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {k: torch.from_numpy(scale * r.normal(size=s).astype(np.float32))
            for k, s in LEAVES.items()}


def test_step_updates_the_state_in_place():
    """The step returns the state it was given, with the same dicts and
    the same moment tensors, updated, and the count advanced; a clone taken
    before the step keeps the values it had."""
    opt = ConverterOptimizer(OPT, 15000)
    params = _leaves(0)
    p0 = {k: p.clone() for k, p in params.items()}
    state = opt.init(params)
    mu, nu = state.mu, state.nu
    tensors = {k: (mu[k], nu[k]) for k in params}
    g, frozen = _leaves(1), _leaves(2)
    first = opt.step(params, g, state, frozen_grads=frozen)
    assert first is state and state.count == 1
    kept = {k: (m.clone(), v.clone()) for k, (m, v) in tensors.items()}
    kept_params = {k: p.clone() for k, p in params.items()}
    out = opt.step(params, _leaves(3), state, frozen_grads=_leaves(4))
    assert out is state and out.mu is mu and out.nu is nu
    assert out.count == 2
    for k in params:
        assert out.mu[k] is tensors[k][0] and out.nu[k] is tensors[k][1]
        assert not torch.equal(out.mu[k], kept[k][0]), k
        assert not torch.equal(out.nu[k], kept[k][1]), k
        assert not torch.equal(params[k], kept_params[k]), k
    # the clones hold the first step's moments: from zero, (1 - B1) u and
    # (1 - B2) u^2 of the clipped gradient u (plus the latent's decay)
    every = list(g.values()) + list(frozen.values())
    norm = torch.sqrt(sum((x * x).sum() for x in every))
    assert float(norm) > 0.1
    for k in params:
        u = g[k] / norm * 0.1
        if param_group(k) == 'tex_latent':
            u = u + 0.05 * p0[k]
        torch.testing.assert_close(kept[k][0], 0.1 * u, rtol=1e-6, atol=0)
        torch.testing.assert_close(kept[k][1], 0.001 * (u * u), rtol=1e-6,
                                   atol=0)


def test_cpu_route_is_the_plain_version():
    """CPU tensors take `step_plain` and launch nothing; the kernel's
    launcher refuses them."""
    opt = ConverterOptimizer(OPT, 15000)
    a, b = _leaves(0), _leaves(0)
    sa, sb = opt.init(a), opt.init(b)
    before = conv_adam.conv_adam_step.launches
    opt.step(a, _leaves(1), sa, frozen_grads=_leaves(2))
    opt.step_plain(b, _leaves(1), sb, frozen_grads=_leaves(2))
    assert conv_adam.conv_adam_step.launches == before
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(sa.mu[k], sb.mu[k])
        assert torch.equal(sa.nu[k], sb.nu[k])
    names = list(a)
    with pytest.raises(ValueError, match='CUDA'):
        conv_adam.conv_adam_step(
            conv_adam.Plan(), list(a.values()), list(sa.mu.values()),
            list(sa.nu.values()), list(_leaves(1).values()), [],
            tuple(GROUPS.index(param_group(k)) for k in names),
            [0.0] * N_ADAM, [0.0] * N_GROUPS, [0.0] * N_GROUPS)


def test_the_groups_fill_the_kernels_rows():
    """The optimizer's groups, named in `scene.py`, are the kernel's rows
    of step sizes and decays, one each, in GROUPS order."""
    opt = ConverterOptimizer(OPT, 15000)
    assert len(GROUPS) == N_GROUPS == len(set(GROUPS))
    assert tuple(opt.lr) == tuple(opt.wd) == GROUPS
    assert {param_group(k) for k in LEAVES} <= set(GROUPS)


def test_empty_converter_and_empty_groups():
    """No parameter: only the count moves. Leaves of some groups only (no
    latent group, as under texture=sh): each group takes its own rate."""
    opt = ConverterOptimizer(OPT, 15000)
    state = opt.init({})
    assert opt.step({}, {}, state) is state and state.count == 1
    keep = ('rigid.lbs_network.lin0.weight', 'pose_correction.betas')
    params = {k: v for k, v in _leaves(0).items() if k in keep}
    before = {k: v.clone() for k, v in params.items()}
    state = opt.init(params)
    g = {k: v for k, v in _leaves(1).items() if k in keep}
    opt.step(params, g, state)
    for k in keep:
        # Adam's first step from zero moments moves each element by its
        # group's learning rate (the count is 0: no decay yet), to the
        # rounding of the parameter (|p| < 4: 2 ulps are 5e-7)
        lr = OPT['opt'][f'{param_group(k)}_lr']
        assert float(before[k].abs().max()) < 4
        np.testing.assert_allclose((params[k] - before[k]).abs().numpy(),
                                   lr, rtol=0, atol=5e-7)


def test_block_table_of_the_zju_converter(zju):
    """The table for the zju377_full converter's 129 leaves and 9 subject
    constants: one norm block per CHUNK elements of each of the 138
    gradients, one update block per CHUNK of each parameter, every element
    in exactly one block of each list, the group ids by the JAX package's
    label rules (no non-rigid latent: its latent_dim is 0)."""
    cfg, params, consts = zju
    assert len(params) == 129 and len(consts) == 9
    assert len(params) + len(consts) <= MAX_TENSORS
    numels = [p.numel() for p in params.values()] + \
        [c.numel() for c in consts.values()]
    assert sum(numels[:129]) == 2237865 and sum(numels[129:]) == 4836792
    n = len(params)
    groups = [GROUPS.index(param_group(k)) for k in params]
    ptrs = [list(range(1000 * i, 1000 * i + n)) for i in (1, 2, 3)]
    words, n_norm, n_update = table_words(numels, n, *ptrs, groups)
    want_norm = sum(-(-k // CHUNK) for k in numels)
    want_update = sum(-(-k // CHUNK) for k in numels[:n])
    assert (n_norm, n_update) == (want_norm, want_update)
    t = len(numels)
    assert words[:t] == numels
    assert words[t:t + 3 * n] == ptrs[0] + ptrs[1] + ptrs[2]
    assert words[t + 3 * n:t + 4 * n] == groups
    assert len(words) == t + 4 * n + n_norm + n_update
    for blocks, count in ((words[t + 4 * n:t + 4 * n + n_norm], t),
                          (words[t + 4 * n + n_norm:], n)):
        covered = [0] * count
        for e in blocks:
            i, c = e >> 32, e & 0xffffffff
            assert c == covered[i] // CHUNK
            covered[i] += min(CHUNK, numels[i] - c * CHUNK)
        assert covered == numels[:count]
    by_group = {g: sum(1 for x in groups if x == GROUPS.index(g))
                for g in GROUPS}
    assert by_group['nr_latent'] == 0
    assert by_group['tex_latent'] == 1 and by_group['pose_correction'] == 5
    assert sum(by_group.values()) == 129
    # the pose encoder's 98 small leaves (96 of them its per-joint layers)
    # take one block each
    small = [i for i, k in enumerate(params) if '.pose_encoder.' in k]
    assert len(small) == 98
    norm_blocks = words[t + 4 * n:t + 4 * n + n_norm]
    assert all(sum(1 for e in norm_blocks if e >> 32 == i) == 1
               for i in small)


def test_the_foreach_yardstick_is_the_plain_step():
    """chip_smoke's `_foreach_` version of the step, timed beside K5 on the
    card, computes the plain version's step: the same expressions over
    every leaf, the clip's scale taken as one product (a few roundings
    of the plain version's, which a sum of two moments' terms of opposite
    sign can raise relative to the sum: held to the tensor's scale)."""
    opt = ConverterOptimizer(OPT, 15000)
    a, b = _leaves(0), _leaves(0)
    sa, sb = opt.init(a), opt.init(b)
    sa.count = sb.count = 7
    for seed in (1, 3):
        g, frozen = _leaves(seed), _leaves(seed + 1)
        assert chip_smoke.k5_foreach_step(opt, a, g, sa, frozen) is sa
        opt.step_plain(b, g, sb, frozen)
        sb.count += 1
    assert sa.count == sb.count == 9
    for k in a:
        for x, y in ((a[k], b[k]), (sa.mu[k], sb.mu[k]),
                     (sa.nu[k], sb.nu[k])):
            torch.testing.assert_close(
                x, y, rtol=1e-6, atol=1e-6 * float(y.abs().max()))


@pytest.mark.parametrize('numels,want', [
    ([], []),
    ([0], []),
    ([0, 1, 0], [(1, 0)]),
    ([CHUNK, CHUNK + 1, 0, 3], [(0, 0), (1, 0), (1, 1), (3, 0)]),
    ([2 * CHUNK], [(0, 0), (0, 1)]),
], ids=['none', 'empty', 'one', 'ragged', 'exact'])
def test_chunk_blocks(numels, want):
    assert chunk_blocks(numels) == [(t << 32) | c for t, c in want]


@pytest.mark.parametrize('make,dense', [
    (lambda: torch.zeros(4, 5), True),
    (lambda: torch.zeros(10, 512, 3).permute(1, 2, 0), True),
    (lambda: torch.zeros(5, 4).t(), True),
    (lambda: torch.zeros(1, 7, 1), True),
    (lambda: torch.zeros(4, 1).expand(4, 3), False),
    (lambda: torch.zeros(4, 6)[:, :3], False),
    (lambda: torch.zeros(8)[::2], False),
], ids=['contiguous', 'shapedirs', 'transposed', 'ones', 'expanded',
        'sliced', 'strided'])
def test_which_layouts_the_norm_reads(make, dense):
    """The norm reads a frozen gradient as one flat run when its elements
    fill numel consecutive floats (the shape blend's gradient comes
    permuted); the update takes contiguous tensors only."""
    assert conv_adam.is_dense(make()) is dense
