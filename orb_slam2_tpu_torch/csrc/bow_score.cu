// BoW scores of one query against the listed rows of a keyframe table, for
// Hopper (sm_90a): each row's L1 score and shared-word count in one pass.
//
// Replaces no TPU kernel: the JAX package scores a query against its whole
// table in XLA's fused elementwise ops (orb_slam2_tpu/place/vocab.py
// l1_score, shared_words).  Added because at the reference vocabulary's
// width (k = 10, L = 6: ~10^6 words; KITTI's [2048, 10^6] f32 table is
// 8.19 GB) the two chunked tensor-op passes it replaces moved ~28 bytes an
// element of the whole table, ~57 GB a loop detection, where the answer
// needs only the rows of live keyframes.
//
// For each i < R, with row = rows[i]:
//   score[i]  = 1 - 0.5 * sum_w |query[w] - table[row, w]|
//   shared[i] = #{w : query[w] > 0 and table[row, w] > 0}
// and score[i] = 0, shared[i] = 0 where row is outside [0, K) (-1: skipped);
// a skipped row is never read.  The plain version is place/vocab.py
// `table_scores_plain` (`l1_score` and `shared_words` over the listed rows).
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32): bytes.  A call reads
// each listed row once and the query: listed rows x W x 4 + W x 4 bytes
// (186 rows at W = 10^6: 0.75 GB, 0.22 ms); 2 f32 operations, 2 compares and
// an integer add an element, a few percent of the f32 rate.  Design:
// - grid (R, segments): a block sums one segment (4,096-32,768 words, at
//   least 8 a row where the row is that long) of one listed row, so ~186
//   live rows x 31 segments at 10^6 words fill the 132 SMs; a block whose
//   row is skipped returns after reading its row id;
// - each thread loads 16 bytes of the row and 16 of the query at a time,
//   UNROLL of each in flight; the rows with the streaming hint (evict
//   first), so that the query, which every row reads, stays in L2;
//   blockIdx.x is the row, so the blocks of one segment run together and
//   share that segment of the query (128 KB at most);
// - a table or query that is not 16-byte aligned (W not a multiple of 4)
//   takes the same loop on 4-byte loads;
// - sums in a fixed order, with no float atomics: each thread over its
//   words in index order, a warp shuffle tree, the warps in index order,
//   then a second kernel adds each row's segments in index order.  Two
//   launches on the same inputs agree bit for bit, and a row's sums do not
//   depend on which other rows are listed.  The wrapper allocates the
//   outputs and the [R, segments] partials; nothing synchronises the host.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define UNROLL 4
#define SEG_MIN 4096
#define SEG_MAX 32768
#define MIN_SEGS 8

// words a segment: W / MIN_SEGS rounded up to a multiple of SEG_MIN (a
// multiple of NT * UNROLL * 4), within [SEG_MIN, SEG_MAX]
static long long segment_words(long long W) {
  long long s = (W + MIN_SEGS - 1) / MIN_SEGS;
  s = (s + SEG_MIN - 1) / SEG_MIN * SEG_MIN;
  return s < SEG_MIN ? SEG_MIN : (s > SEG_MAX ? SEG_MAX : s);
}

static long long n_segments(long long W) {
  const long long seg = segment_words(W);
  return W > 0 ? (W + seg - 1) / seg : 1;
}

__device__ __forceinline__ void add(float q, float t, float& acc, int& cnt) {
  acc += fabsf(q - t);
  cnt += (q > 0.0f) & (t > 0.0f);
}

template <int VEC>
__global__ void __launch_bounds__(NT)
bow_partial_kernel(const float* __restrict__ query,
                   const float* __restrict__ table,
                   const long long* __restrict__ rows, long long K,
                   long long W, long long seg, float* __restrict__ part_l1,
                   int* __restrict__ part_sw) {
  const long long row = rows[blockIdx.x];
  if (row < 0 || row >= K) return;
  const long long lo = (long long)blockIdx.y * seg;
  const int n = (int)(W - lo < seg ? W - lo : seg);  // this segment's words
  const float* t = table + row * W + lo;
  const float* q = query + lo;
  float acc = 0.0f;
  int cnt = 0;
  if (VEC == 4) {
    const float4* t4 = reinterpret_cast<const float4*>(t);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int n4 = n >> 2;  // W, lo and seg are multiples of 4 here
    for (int i = threadIdx.x; i < n4; i += NT * UNROLL) {
      float4 tv[UNROLL], qv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = i + u * NT;
        if (j < n4) {
          tv[u] = __ldcs(t4 + j);
          qv[u] = __ldg(q4 + j);
        } else {
          tv[u] = qv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        add(qv[u].x, tv[u].x, acc, cnt);
        add(qv[u].y, tv[u].y, acc, cnt);
        add(qv[u].z, tv[u].z, acc, cnt);
        add(qv[u].w, tv[u].w, acc, cnt);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += NT * UNROLL) {
      float tv[UNROLL], qv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = i + u * NT;
        tv[u] = j < n ? __ldcs(t + j) : 0.0f;
        qv[u] = j < n ? __ldg(q + j) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) add(qv[u], tv[u], acc, cnt);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  __shared__ float s_acc[NT / 32];
  __shared__ int s_cnt[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_acc[warp] = acc;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = s_acc[0];
    int c = s_cnt[0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) {
      a += s_acc[w];
      c += s_cnt[w];
    }
    const size_t o = (size_t)blockIdx.x * gridDim.y + blockIdx.y;
    part_l1[o] = a;
    part_sw[o] = c;
  }
}

__global__ void __launch_bounds__(NT)
bow_combine_kernel(const long long* __restrict__ rows, long long K, int R,
                   int nseg, const float* __restrict__ part_l1,
                   const int* __restrict__ part_sw, float* __restrict__ score,
                   int* __restrict__ shared, int* __restrict__ count) {
  const int i = blockIdx.x * NT + threadIdx.x;
  // calls and rows scored, counted on the device (also under graph replay)
  if (count != nullptr && i == 0) atomicAdd(count, 1);
  if (i >= R) return;
  const long long row = rows[i];
  if (row < 0 || row >= K) {
    score[i] = 0.0f;
    shared[i] = 0;
    return;
  }
  const size_t o = (size_t)i * nseg;
  float a = part_l1[o];
  int c = part_sw[o];
  for (int s = 1; s < nseg; ++s) {
    a += part_l1[o + s];
    c += part_sw[o + s];
  }
  score[i] = 1.0f - 0.5f * a;  // 0.5 * a is exact: one rounding, as plain
  shared[i] = c;
  if (count != nullptr) atomicAdd(count + 1, 1);
}

// the number of segments a row of W words is cut into: the partials'
// second extent
extern "C" long long bow_score_segments(long long W) { return n_segments(W); }

// C interface for ctypes.  query [W] and table [K, W] f32, rows [R] int64,
// all device memory; part_l1 / part_sw [R, bow_score_segments(W)] scratch;
// score [R] f32 and shared [R] int32 out; `count` (device memory, or null)
// gains 1 call and the rows scored.  Launches both kernels on `stream`;
// returns cudaGetLastError().
extern "C" int bow_score_launch(const float* query, const float* table,
                                const long long* rows, long long K,
                                long long W, int R, float* part_l1,
                                int* part_sw, float* score, int* shared,
                                int* count, void* stream) {
  if (R < 1 || K < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const long long seg = segment_words(W);
  const long long nseg = n_segments(W);
  if (nseg > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)R, (unsigned)nseg);
  const bool vec = W % 4 == 0 && (uintptr_t)query % 16 == 0 &&
                   (uintptr_t)table % 16 == 0;
  if (vec)
    bow_partial_kernel<4><<<grid, NT, 0, st>>>(query, table, rows, K, W, seg,
                                               part_l1, part_sw);
  else
    bow_partial_kernel<1><<<grid, NT, 0, st>>>(query, table, rows, K, W, seg,
                                               part_l1, part_sw);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bow_combine_kernel<<<(R + NT - 1) / NT, NT, 0, st>>>(
      rows, K, R, (int)nseg, part_l1, part_sw, score, shared, count);
  return (int)cudaGetLastError();
}
