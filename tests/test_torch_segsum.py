"""gsavatar_torch's segment sums (K3's plain version and ops/segsum.py)
against gsavatar's on the CPU: the Pallas kernel in interpret mode, the
portable cumsum formulation, the unsorted and per-level variants, and the
gradient of `gather_rows`.

Tolerances: against the interpret-mode kernel, 1e-5 of each segment's sum
of |values| (the kernel splits values in bf16 hi/lo parts, ~2^-18 relative
per value; the plain version sums in float64); against the cumsum
formulation, 4 f32 ulps of the largest running sum (its error is a
difference of two f32 prefix sums). Dropped ids carry NaN, which neither
side may read."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers  # noqa: F401  (torch on one thread)

from gsavatar_torch.ops import segsum as tseg
from gsavatar_torch.ops.segsum_blocked import (
    CHUNK_ROWS, SMALL_CHUNK_ROWS, SMALL_ROWS, carry_records, chunk_rows,
    segment_sum_sorted_blocked,
    segment_sum_sorted_blocked_plain)

from gsavatar.ops import segsum as jseg
from gsavatar.ops.segsum_pallas import segment_sum_sorted_blocked_t


def _sorted_input(M, C, S, seed, drop=20, gap=3):
    """Sorted ids with empty segments (every `gap`-th id unused) and `drop`
    dropped rows (ids >= S) carrying NaN."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S, size=M - drop)
    ids = ids[ids % gap != 1]
    ids = np.sort(np.concatenate([ids, rng.integers(S, S + 40, size=drop)]))
    vals = rng.standard_normal((ids.shape[0], C)).astype(np.float32)
    vals[ids >= S] = np.nan
    return ids.astype(np.int32), vals


def _cumsum_atol(vals_sorted):
    """4 f32 ulps of the largest running sum over the rows in sorted
    order: the error bound of the JAX package's cumsum formulation."""
    running = np.abs(np.cumsum(np.nan_to_num(vals_sorted), axis=0)).max()
    return 4 * np.finfo(np.float32).eps * running


def _abs_sums(ids, vals, S):
    out = np.zeros((S, vals.shape[1]))
    keep = ids < S
    np.add.at(out, ids[keep], np.abs(vals[keep]).astype(np.float64))
    return out


@pytest.mark.parametrize('M,C,S', [(1536, 2, 300), (2000, 9, 700),
                                   (900, 1, 1100)])
def test_plain_k3_matches_pallas_interpret(M, C, S):
    ids, vals = _sorted_input(M, C, S, seed=C)
    got = segment_sum_sorted_blocked_plain(torch.from_numpy(vals),
                                           torch.from_numpy(ids), S)
    want = np.asarray(segment_sum_sorted_blocked_t(
        jnp.asarray(vals.T), jnp.asarray(ids), S, interpret=True))
    assert got.shape == (S, C) and got.dtype == torch.float32
    assert bool(got.isfinite().all())
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 1e-5 * _abs_sums(ids, vals, S) + 1e-30)
    empty = np.setdiff1d(np.arange(S), ids)
    assert empty.size and not got.numpy()[empty].any()


@pytest.mark.parametrize('M,C,S', [(5000, 3, 1200), (20000, 6, 4000)])
def test_plain_k3_matches_cumsum_formulation(M, C, S):
    ids, vals = _sorted_input(M, C, S, seed=M)
    got = segment_sum_sorted_blocked_plain(torch.from_numpy(vals),
                                           torch.from_numpy(ids), S)
    want = np.asarray(jseg.segment_sum_sorted(jnp.asarray(vals),
                                              jnp.asarray(ids), S))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_cumsum_atol(vals))


@pytest.mark.parametrize('S', [0, 5])
@pytest.mark.parametrize('C', [2, 9])
def test_plain_k3_without_rows_gives_zeros(S, C):
    """M = 0 rows: the JAX cumsum formulation pads its running sum with a
    zero row and returns zeros; so does the plain version (it indexed an
    empty running sum before)."""
    vals = np.zeros((0, C), np.float32)
    ids = np.zeros(0, np.int32)
    got = segment_sum_sorted_blocked_plain(torch.from_numpy(vals),
                                           torch.from_numpy(ids), S)
    want = np.asarray(jseg.segment_sum_sorted(jnp.asarray(vals),
                                              jnp.asarray(ids), S))
    assert got.shape == want.shape == (S, C) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.any()


def test_k3_wrapper_takes_plain_version_only_for_cpu_tensors():
    ids, vals = _sorted_input(400, 2, 100, seed=3)
    before = segment_sum_sorted_blocked.launches
    out = segment_sum_sorted_blocked(torch.from_numpy(vals),
                                     torch.from_numpy(ids), 100)
    assert segment_sum_sorted_blocked.launches == before
    torch.testing.assert_close(out, segment_sum_sorted_blocked_plain(
        torch.from_numpy(vals), torch.from_numpy(ids), 100))
    with pytest.raises(ValueError):
        segment_sum_sorted_blocked(torch.from_numpy(vals).to('meta'),
                                   torch.from_numpy(ids).to('meta'), 100)


def test_carry_records_two_per_chunk():
    """The wrapper's sizing: 64-row chunks under 2^20 rows, 256-row chunks
    from there, two carry records per chunk, a ragged last chunk included,
    none for no rows."""
    assert chunk_rows(SMALL_ROWS - 1) == SMALL_CHUNK_ROWS == 64
    assert chunk_rows(SMALL_ROWS) == CHUNK_ROWS == 256
    assert carry_records(0) == 0
    assert carry_records(1) == 2
    assert carry_records(SMALL_CHUNK_ROWS) == 2
    assert carry_records(SMALL_CHUNK_ROWS + 1) == 4
    assert carry_records(116731) == 2 * 1824            # pair gradients
    assert carry_records(SMALL_ROWS + 1) == 2 * (SMALL_ROWS // 256 + 1)
    assert carry_records(16 * 8 * 53248) == 2 * 16 * 8 * 53248 // 256


def _chunked_model(vals, ids, S, chunk):
    """csrc/segsum.cu's partition in numpy, to check its bookkeeping on the
    CPU: each chunk of `chunk` rows stores the runs that lie wholly
    inside it, zeroes the empty segments after each run that ends in it
    (chunk 0 also those before the first row), and writes two carry
    records (its first and last run; a one-run chunk's second record holds
    zeros; a dropped run's id is -1); then the first record of each id
    sums that id's records in order. Every output row must be written
    exactly once."""
    M, C = vals.shape
    n_rec = 2 * (-(-M // chunk))
    out = np.full((S, C), np.nan)
    writes = np.zeros(S, int)

    def write(lo, hi, value):
        out[lo:hi] = value
        writes[lo:hi] += 1

    if M:
        write(0, max(min(int(ids[0]), S), 0), 0.0)
    else:
        write(0, S, 0.0)
    rec_id = np.full(n_rec, -2)
    rec_val = np.zeros((n_rec, C))
    for w in range(n_rec // 2):
        lo_row = w * chunk
        cid = ids[lo_row:lo_row + chunk]
        ok = (cid >= 0) & (cid < S)
        cv = np.where(ok[:, None], vals[lo_row:lo_row + chunk], 0.0)
        cut = np.flatnonzero(np.diff(cid)) + 1
        runs = list(zip(np.r_[0, cut], np.r_[cut, len(cid)]))
        for k, (a, b) in enumerate(runs):
            s, my = cv[a:b].astype(np.float64).sum(0), int(cid[a])
            rid = my if 0 <= my < S else -1
            if k == 0:
                rec_id[2 * w], rec_val[2 * w] = rid, s
            if k == len(runs) - 1:
                rec_id[2 * w + 1] = rid
                rec_val[2 * w + 1] = 0.0 if k == 0 else s
            if 0 < k < len(runs) - 1 and rid >= 0:
                write(my, my + 1, s)
            nxt = int(ids[lo_row + b]) if lo_row + b < M else S
            write(max(my + 1, 0), min(nxt, S), 0.0)
    assert not (rec_id == -2).any()          # every record is written
    for r in range(n_rec):
        my = rec_id[r]
        if my < 0 or (r > 0 and rec_id[r - 1] == my):
            continue
        q = r
        while q < n_rec and rec_id[q] == my:
            q += 1
        write(my, my + 1, rec_val[r:q].sum(0))
    assert (writes == 1).all()               # every row written once
    return out


def _runs_input(lengths, C, S, seed, drop=0):
    """Sorted ids with runs of the given lengths over a spread of segment
    ids, then `drop` dropped rows (ids >= S) carrying NaN."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.choice(S, size=len(lengths), replace=False))
    ids = np.concatenate([np.repeat(seg, lengths),
                          rng.integers(S, S + 9, size=drop)])
    ids = np.sort(ids).astype(np.int32)
    vals = rng.standard_normal((ids.shape[0], C)).astype(np.float32)
    vals[ids >= S] = np.nan
    return ids, vals


@pytest.mark.parametrize('chunk', [SMALL_CHUNK_ROWS, CHUNK_ROWS])
@pytest.mark.parametrize('case', ['spanning_chunks', 'one_segment', 'ragged',
                                  'only_dropped'])
def test_chunked_partition_matches_pallas_interpret(case, chunk):
    """The kernel's chunk and carry bookkeeping (`_chunked_model`) and the
    plain version against the JAX kernel in interpret mode: segments that
    span many chunks, one segment holding every row, a row count that is
    not a multiple of the chunk, and only dropped rows."""
    rng = np.random.default_rng(11)
    S, C = 600, 2
    if case == 'spanning_chunks':
        ids, vals = _runs_input(rng.integers(1, 1300, size=12), C, S, 1,
                                drop=30)
    elif case == 'one_segment':
        ids, vals = _runs_input([5 * chunk + 3], C, S, 2)
    elif case == 'ragged':
        ids, vals = _sorted_input(7 * chunk + 77, C, S, seed=3)
    else:
        ids = np.sort(rng.integers(S, S + 50, size=700)).astype(np.int32)
        vals = np.full((700, C), np.nan, np.float32)
    want = np.asarray(segment_sum_sorted_blocked_t(
        jnp.asarray(vals.T), jnp.asarray(ids), S, interpret=True))
    tol = 1e-5 * _abs_sums(ids, vals, S) + 1e-30
    np.testing.assert_array_less(
        np.abs(_chunked_model(vals, ids, S, chunk) - want), tol)
    got = segment_sum_sorted_blocked(torch.from_numpy(vals),
                                     torch.from_numpy(ids), S)
    np.testing.assert_array_less(np.abs(got.numpy() - want), tol)
    if case == 'only_dropped':
        assert not got.numpy().any()


def test_segment_sum_unsorted_matches_jax():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 600, size=4000).astype(np.int32)
    vals = rng.standard_normal((4000, 9)).astype(np.float32)
    got = tseg.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), 500)
    want = np.asarray(jseg.segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                       500))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_cumsum_atol(vals[np.argsort(ids)]))


def test_segment_sum_leveled_matches_jax():
    """Per-level ids with the level offsets: one sorted id sequence over
    every level (the hash-table backward)."""
    rng = np.random.default_rng(6)
    L, Mp, T = 4, 3000, 256
    ids = rng.integers(0, T, size=(L, Mp)).astype(np.int32)
    vals = rng.standard_normal((L, Mp, 2)).astype(np.float32)
    got = tseg.segment_sum_leveled(torch.from_numpy(vals),
                                   torch.from_numpy(ids), T)
    want = np.asarray(jseg.segment_sum_leveled(jnp.asarray(vals),
                                               jnp.asarray(ids), T))
    assert got.shape == (L * T, 2)
    order = np.argsort(ids, axis=1, kind='stable')
    flat = np.take_along_axis(vals, order[..., None], axis=1).reshape(-1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_cumsum_atol(flat))


@pytest.mark.parametrize('C', [3, 6])
def test_gather_rows_value_and_gradient(C):
    """Forward: a clipped row gather (ids >= S read the last row). Backward:
    the cotangent rows summed per source row, out-of-range ids dropped."""
    rng = np.random.default_rng(C)
    S, M = 300, 1500
    src = rng.standard_normal((S, C)).astype(np.float32)
    idx = rng.integers(0, S + 10, size=M).astype(np.int32)
    ct = rng.standard_normal((M, C)).astype(np.float32)
    t_src = torch.from_numpy(src).requires_grad_()
    out = tseg.gather_rows(t_src, torch.from_numpy(idx))
    (t_grad,) = torch.autograd.grad(out, t_src, torch.from_numpy(ct))
    j_out, vjp = jax.vjp(lambda s: jseg.gather_rows(s, jnp.asarray(idx)),
                         jnp.asarray(src))
    (j_grad,) = vjp(jnp.asarray(ct))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(j_out))
    np.testing.assert_allclose(
        t_grad.numpy(), np.asarray(j_grad), rtol=0,
        atol=_cumsum_atol(ct[np.argsort(idx)]))
    ref = np.zeros((S, C))
    keep = idx < S
    np.add.at(ref, idx[keep], ct[keep])
    np.testing.assert_allclose(t_grad.numpy(), ref, rtol=0, atol=1e-5)
