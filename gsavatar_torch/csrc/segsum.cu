// K3: the sorted segment sum, for Hopper (sm_90a).
//
// Replaces gsavatar/ops/segsum_pallas.py:_kernel (the Pallas TPU kernel
// behind segment_sum_sorted_blocked_t). Same function: values (M, C) f32,
// row-major, and seg_ids (M,) int32 sorted ascending; out (S, C) f32 holds
// the sum of the rows of each segment, 0 for an empty one. Ids outside
// [0, S) are dropped: their rows are read but replaced by zero before any
// add, so garbage (NaN) there cannot reach a sum.
//
// What bounds it on this card: the bytes, M (4 + 4C) read and S 4C written,
// over 3.35 TB/s; there is one add per value. The work is split by input
// rows, so every warp streams the same number of bytes whatever the
// segments look like (a dense coarse hash level, whose 425,984 rows fall
// into a few thousand cells, costs what a fine level costs), and its loads
// are coalesced.
//
// Design, in two kernels on one stream:
// 1. segsum_chunks: each warp owns a chunk of 256 rows (64 rows for inputs
//    under 2^20 rows, so that they still fill the card). It stages the
//    chunk's values in shared memory with 16-byte asynchronous copies
//    (cp.async: all in flight at once, holding no registers), then walks
//    the chunk as eight tiles of 32 rows, lane i on row i of the tile. A
//    segmented inclusive scan over the tile (five shuffle steps; a lane adds
//    the partial sum d lanes down only while that lane is in its own run,
//    known from a ballot of the run heads) leaves each run's sum on its
//    last lane; the sum of the run that reaches the end of a tile is
//    carried into the next. A run
//    that lies wholly inside the chunk is stored once, with no atomics. The
//    chunk's first and last runs may continue in the neighbouring chunks:
//    their partial sums go to two carry records per chunk (id, C values),
//    the first run's at 2w and the last run's at 2w + 1 (when the chunk is
//    one run, the second record holds its id and zeros; a dropped run's
//    record holds id -1). The lane that ends a run also zeroes the empty
//    segments between its id and the next row's (the whole warp when they
//    are many), chunk 0 those before the first row, and the last row those
//    up to S, so every output row is written once without a memset;
// 2. segsum_carries: the carry records, in chunk order, are again sorted by
//    id. The thread of the first record of each id adds that id's next
//    eight records in order and stores the sum; a longer group, a segment
//    over many chunks (a crowded cell of a dense hash level, a point that
//    is the neighbour of thousands of others), is finished by the whole
//    warp, 32 records a step. It is launched as a programmatic
//    dependent launch: its launch overlaps the chunks' run, and it waits
//    (griddepcontrol.wait) for their records before it reads any.
// Every add happens in an order fixed by the input alone (the scan's tree,
// the tiles in order, the chunks in order), so the same input gives the
// same bits on every run, as the JAX kernel's sums do.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
// a chunk (one warp) holds kTiles 32-row tiles: 8 (256 rows) for large
// inputs, 2 (64 rows) below kSmallRows rows, where 256-row chunks would
// leave most of the card's warps idle
constexpr int kSmallRows = 1 << 20;
constexpr int kWarps = 4;                   // chunks per block
constexpr int kThreads = kLanes * kWarps;
constexpr int kCarryThreads = 256;
constexpr int kAhead = 8;                   // carry records looked ahead
constexpr int kShortGap = 4;                // empty rows a lane zeroes alone
constexpr unsigned kFull = 0xffffffffu;

// Row r's C values from the chunk's staging buffer: 8-byte reads for even
// C, so that neither width has bank conflicts.
template <int C>
__device__ __forceinline__ void read_row(const float* s, int r,
                                         float (&v)[C]) {
  if constexpr (C % 2 == 0) {
    const float2* p = reinterpret_cast<const float2*>(s + r * C);
#pragma unroll
    for (int c = 0; c < C / 2; ++c) {
      const float2 x = p[c];
      v[2 * c] = x.x;
      v[2 * c + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = s[r * C + c];
  }
}

template <int C>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[C]) {
  if constexpr (C % 2 == 0) {
    float2* p = reinterpret_cast<float2*>(dst);
#pragma unroll
    for (int c = 0; c < C / 2; ++c)
      p[c] = make_float2(v[2 * c], v[2 * c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = v[c];
  }
}

// Zeroes output rows [lo, hi) of each lane (an empty range where hi <= lo):
// a short range by its own lane, a long one by the whole warp, so that the
// thousands of empty cells at the end of a dense hash level take no single
// lane thousands of stores.
template <int C>
__device__ __forceinline__ void zero_gap(float* out, int lo, int hi) {
  const int lane = threadIdx.x % kLanes;
  float z[C];
#pragma unroll
  for (int c = 0; c < C; ++c) z[c] = 0.0f;
  const bool mine = hi - lo <= kShortGap;
  if (mine)
    for (int s = lo; s < hi; ++s) store_row<C>(out + (long long)s * C, z);
  for (unsigned long_gaps = __ballot_sync(kFull, !mine); long_gaps;
       long_gaps &= long_gaps - 1) {
    const int b = __ffs(long_gaps) - 1;
    const int glo = __shfl_sync(kFull, lo, b);
    const int ghi = __shfl_sync(kFull, hi, b);
    for (int s = glo + lane; s < ghi; s += kLanes)
      store_row<C>(out + (long long)s * C, z);
  }
}

template <int C, int kTiles>
__global__ void __launch_bounds__(kThreads)
segsum_chunks(const float* __restrict__ values, const int* __restrict__ ids,
              long long num_rows, int num_segments,
              float* __restrict__ out, int* __restrict__ rec_id,
              float* __restrict__ rec_val) {
  constexpr int kChunk = kLanes * kTiles;
  __shared__ float4 s_stage[kWarps][kChunk * C / 4];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const long long chunk = (long long)blockIdx.x * kWarps + warp;
  const long long row0 = chunk * kChunk;
  if (row0 >= num_rows) return;
  const int n = (int)min((long long)kChunk, num_rows - row0);
  float* sv = reinterpret_cast<float*>(s_stage[warp]);

  // ids: lane i holds row 32 k + i of each tile k; -1 past the end. `after`
  // is the id of the row after the chunk (S past the last row)
  int id[kTiles];
#pragma unroll
  for (int k = 0; k < kTiles; ++k) {
    const int r = k * kLanes + lane;
    id[k] = r < n ? ids[row0 + r] : -1;
  }
  const int after = row0 + n < num_rows ? ids[row0 + n] : num_segments;

  // values: the chunk's n C floats, staged in shared memory
  const long long e0 = row0 * C;
  const int ne = n * C;
  // e0 * 4 bytes is a multiple of 16, since a chunk holds 64 C or 256 C
  // floats
  const float4* src = reinterpret_cast<const float4*>(values + e0);
  const int n4 = ne / 4;
  for (int i = lane; i < n4; i += kLanes)
    __pipeline_memcpy_async(&s_stage[warp][i], &src[i], sizeof(float4));
  __pipeline_commit();
  for (int i = n4 * 4 + lane; i < ne; i += kLanes) sv[i] = values[e0 + i];
  __pipeline_wait_prior(0);
  __syncwarp();

  // the segments before the first row hold no rows: zero them
  if (chunk == 0)
    zero_gap<C>(out, 0, lane == 0 ? min(id[0], num_segments) : 0);

  const int first = __shfl_sync(kFull, id[0], 0);
  float carry[C];
#pragma unroll
  for (int c = 0; c < C; ++c) carry[c] = 0.0f;
  int carry_id = 0;

#pragma unroll
  for (int k = 0; k < kTiles; ++k) {
    if (k * kLanes >= n) break;
    const int r = k * kLanes + lane;
    const int my = id[k];
    const bool valid = my >= 0 && my < num_segments;
    float v[C];
    read_row<C>(sv, r, v);
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = valid ? v[c] : 0.0f;

    // the run heads of the tile; `start` is the first lane of my run
    const int prev = __shfl_up_sync(kFull, my, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != my);
    const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float u = __shfl_up_sync(kFull, v[c], d);
        if (lane - d >= start) v[c] += u;
      }
    }
    if (k > 0 && start == 0 && my == carry_id) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] += carry[c];
    }

    // the id of the next row: the next lane's, the first of the next tile,
    // or `after`
    const int next_tile =
        __shfl_sync(kFull, id[min(k + 1, kTiles - 1)], 0);
    const int down = __shfl_down_sync(kFull, my, 1);
    int next = lane < kLanes - 1 ? down : next_tile;
    if (r == n - 1) next = after;
    const bool ends = r < n && next != my;
    if (r < n && (ends || r == n - 1)) {
      const bool is_head = my == first;
      const bool is_tail = r == n - 1;
      if (is_head) {
        rec_id[2 * chunk] = valid ? my : -1;
        store_row<C>(rec_val + (2 * chunk) * C, v);
      }
      if (is_tail) {
        float z[C];
#pragma unroll
        for (int c = 0; c < C; ++c) z[c] = is_head ? 0.0f : v[c];
        rec_id[2 * chunk + 1] = valid ? my : -1;
        store_row<C>(rec_val + (2 * chunk + 1) * C, z);
      }
      if (!is_head && !is_tail && valid)
        store_row<C>(out + (long long)my * C, v);
    }
    // the segments between my run and the next hold no rows: zero them
    zero_gap<C>(out, ends ? max(my + 1, 0) : 0,
                ends ? min(next, num_segments) : 0);
    carry_id = __shfl_sync(kFull, my, kLanes - 1);
#pragma unroll
    for (int c = 0; c < C; ++c)
      carry[c] = __shfl_sync(kFull, v[c], kLanes - 1);
  }
}

template <int C>
__global__ void __launch_bounds__(kCarryThreads)
segsum_carries(const int* __restrict__ rec_id,
               const float* __restrict__ rec_val, int n_rec,
               int num_segments, float* __restrict__ out) {
  // launched while segsum_chunks still runs (programmatic dependent
  // launch); wait here until its records are written
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x % kLanes;
  const int r = blockIdx.x * kCarryThreads + threadIdx.x;
  const int my = r < n_rec ? rec_id[r] : -1;
  // the thread of a group's first record adds its next kAhead records too
  const bool lead = my >= 0 && my < num_segments &&
                    (r == 0 || rec_id[r - 1] != my);
  float sum[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    sum[c] = lead ? rec_val[(long long)r * C + c] : 0.0f;
  bool open = lead;   // the group goes on past the records added so far
  if (lead) {
    int qid[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      qid[u] = r + 1 + u < n_rec ? rec_id[r + 1 + u] : -1;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      open = open && qid[u] == my;
      if (open) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          sum[c] += rec_val[(long long)(r + 1 + u) * C + c];
      }
    }
  }
  // a longer group (a segment over many chunks): the whole warp adds the
  // rest, 32 records a step with each lane on its own records, then a
  // shuffle tree; the order is fixed by the records alone
  for (unsigned groups = __ballot_sync(kFull, open); groups;
       groups &= groups - 1) {
    const int b = __ffs(groups) - 1;
    const int gid = __shfl_sync(kFull, my, b);
    const int g0 = __shfl_sync(kFull, r, b) + 1 + kAhead;
    float part[C];
#pragma unroll
    for (int c = 0; c < C; ++c) part[c] = 0.0f;
    for (int base = g0;; base += kLanes) {
      const int q = base + lane;
      const bool same = q < n_rec && rec_id[q] == gid;
      if (same) {
#pragma unroll
        for (int c = 0; c < C; ++c) part[c] += rec_val[(long long)q * C + c];
      }
      if (!__all_sync(kFull, same)) break;
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o /= 2) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        part[c] += __shfl_xor_sync(kFull, part[c], o);
    }
    if (lane == b) {
#pragma unroll
      for (int c = 0; c < C; ++c) sum[c] += part[c];
    }
  }
  if (lead) store_row<C>(out + (long long)my * C, sum);
}

template <int C, int kTiles>
cudaError_t launch(const float* values, const int* ids, float* out,
                   int* rec_id, float* rec_val, long long num_rows,
                   int num_segments, cudaStream_t stream) {
  constexpr int kChunk = kLanes * kTiles;
  const long long n_chunks = (num_rows + kChunk - 1) / kChunk;
  const long long n_blocks = (n_chunks + kWarps - 1) / kWarps;
  const int n_rec = static_cast<int>(2 * n_chunks);
  segsum_chunks<C, kTiles>
      <<<static_cast<unsigned>(n_blocks), kThreads, 0, stream>>>(
      values, ids, num_rows, num_segments, out, rec_id, rec_val);
  // the carries' launch overlaps the chunks' run; the kernel waits for it
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_rec + kCarryThreads - 1) / kCarryThreads);
  cfg.blockDim = dim3(kCarryThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, segsum_carries<C>,
                            static_cast<const int*>(rec_id),
                            static_cast<const float*>(rec_val), n_rec,
                            num_segments, out);
}

}  // namespace

// Plain C entry point for ctypes: values (num_rows, n_cols) f32 and
// 16-byte aligned, ids
// (num_rows,) int32 sorted, out (num_segments, n_cols) f32, and the carry
// records rec_id (2 n_chunks,) int32 and rec_val (2 n_chunks, n_cols) f32
// with n_chunks = ceil(num_rows / chunk rows), 64 rows below 2^20 rows and
// 256 from there. Built for the column counts of the
// training step only: 2 (hash table), 3 and 6 (AIAP gathers) and 9 (pair
// gradients). Launches on `stream` and returns cudaGetLastError() (0 =
// launched; cudaErrorInvalidValue for any other column count).
extern "C" int gs_segsum(const void* values, const void* ids, void* out,
                         void* rec_id, void* rec_val, long long num_rows,
                         int n_cols, int num_segments, void* stream) {
  if (n_cols != 2 && n_cols != 3 && n_cols != 6 && n_cols != 9)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows == 0 && num_segments > 0) {
    // no chunk to zero the empty segments
    const cudaError_t err = cudaMemsetAsync(
        out, 0, sizeof(float) * (size_t)num_segments * n_cols, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_rows == 0 || num_segments == 0)
    return static_cast<int>(cudaGetLastError());
  const float* v = static_cast<const float*>(values);
  const int* i = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  int* ri = static_cast<int*>(rec_id);
  float* rv = static_cast<float*>(rec_val);
  const bool small = num_rows < kSmallRows;
  cudaError_t err;
  switch (n_cols) {
    case 2:
      err = small ? launch<2, 2>(v, i, o, ri, rv, num_rows, num_segments, st)
                  : launch<2, 8>(v, i, o, ri, rv, num_rows, num_segments, st);
      break;
    case 3:
      err = small ? launch<3, 2>(v, i, o, ri, rv, num_rows, num_segments, st)
                  : launch<3, 8>(v, i, o, ri, rv, num_rows, num_segments, st);
      break;
    case 6:
      err = small ? launch<6, 2>(v, i, o, ri, rv, num_rows, num_segments, st)
                  : launch<6, 8>(v, i, o, ri, rv, num_rows, num_segments, st);
      break;
    default:
      err = small ? launch<9, 2>(v, i, o, ri, rv, num_rows, num_segments, st)
                  : launch<9, 8>(v, i, o, ri, rv, num_rows, num_segments, st);
      break;
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
