// Motion-only pose optimization (the whole 4 x 10 Levenberg-Marquardt
// schedule) for Hopper (sm_90a), one thread-block cluster per problem.
//
// Replaces the Pallas TPU kernel scripts/study_pallas_pose.py (_make_kernel,
// launched by _run; pose_optimize_pallas is its drop-in for
// solvers/pose_opt.pose_optimize).  Computes, for each of B problems, the
// function of pose_optimize_plain in orb_slam2_tpu_torch/solvers/pose_opt.py
// (reference Optimizer::PoseOptimization): `rounds` rounds of up to `iters`
// LM iterations over one SE3 pose against fixed points, Huber IRLS weights
// in every round but the last, analytic Jacobians of the left-multiplied
// exp map, the 6x6 normal equations solved by Cholesky (pivots clamped as
// sqrt(max(s, 1e-12)), as the TPU kernel), left-exp retraction (quaternion
// normalized twice, canonical sign w >= 0), accept when the robust cost
// drops and the new pose is finite, lambda x0.5 on accept and x lam_factor
// on reject clipped to [1e-10, 1e6], and chi^2 inlier reclassification
// after each round (chi2_mono / chi2_stereo).
//
// Convergence stop: a round ends early once an accepted step changed the
// robust cost by < 1e-5 relative AND moved the pose by |dx|^2 < 1e-10 — the
// JAX main path's while_loop (orb_slam2_tpu/solvers/pose_opt.py:122-128).
// The TPU study kernel runs all iterations; after that stop they are no-ops.
//
// What bounds it on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32): not bytes
// (~31 KB a problem at N = 1024, ~10 ns) nor FP32 work (~1e7 operations,
// ~0.2 us) but the serial chain of ~20-40 dependent LM iterations, each a
// pass over the points, a reduction across the problem's threads and a 6x6
// solve.  The design shortens every link of that chain:
//
// * One pass and one reduction per iteration.  The pass at the trial pose
//   Tn yields its robust cost AND its normal equations (21 H + 6 g + cost,
//   28 sums).  On accept those are exactly what the next iteration would
//   recompute at Tn (same active set, same Huber choice within a round); on
//   reject T is unchanged, so the previous H and g are kept and only lambda
//   moves.  Each round adds one linearization at its start pose, which also
//   reclassifies the inliers of the previous round.
// * A cluster of CLUSTER blocks on neighbouring SMs per problem, each block
//   holding N / CLUSTER points in registers, loaded once per launch.  The
//   active flags live in registers; `inlier` is written once at the end.
// * The reduction: each warp reduce-scatters its 32 padded sums in 31
//   shuffles (lane j ends with the warp's sum of value j) and stores them
//   with st.async into every block's shared memory (double-buffered across
//   reductions), each store completing bytes on the receiving block's
//   mbarrier.  A block waits on its own mbarrier only — no cluster-wide
//   barrier in the loop — then every thread adds the CLUSTER x 8 warp
//   partials in a fixed order (block rank, then warp) from its own shared
//   memory and reads the 28 totals back by shuffles.
// * Every thread of every block then solves, retracts and takes the
//   accept / convergence decision itself, from the same totals by the same
//   instructions, so all get the same bits: no one-thread section and no
//   broadcast.  No atomics and a fixed order of summation: two launches
//   give bit-identical results.
//
// Mono rows have ur = -1 and a zero third residual.  All FP32 scalar
// arithmetic without fast-math (sqrtf/sinf/cosf and divisions stay IEEE,
// as in the plain version): no tensor cores, so TF32 does not arise.  The
// IEEE Cholesky and retraction, one thread's dependent chain each, are now
// the largest share of a pass (pose_lm_profile.py, PERF.md).  CLUSTER is a
// compile-time constant, the fastest of 1, 2, 4, 8 blocks measured at
// N = 1024 mono (PERF.md); chip_smoke.py builds the other sizes with
// -DPOSE_LM_CLUSTER=C to time them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifndef POSE_LM_CLUSTER
#define POSE_LM_CLUSTER 4
#endif

constexpr int CLUSTER = POSE_LM_CLUSTER;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NACC = 28;      // 21 H (lower triangle) + 6 g + cost
constexpr int MAX_PPT = 8;    // points a thread holds, at most
constexpr unsigned FULL = 0xffffffffu;

struct Pose {
  float q[4];
  float t[3];
};

#if defined(POSE_LM_PROFILE) || defined(POSE_LM_TIMER)
// Timing builds (orb_slam2_tpu_torch/pose_lm_profile.py).  -DPOSE_LM_TIMER:
// thread 0 of the launch's first block records its whole run, [5] SM
// cycles and [6] ns of the global timer, two reads a launch, so the
// kernel's own time.  -DPOSE_LM_PROFILE adds the SM cycles it spends in
// each phase of a pass, summed over the launch: [0] linearization, [1]
// reduction and exchange, [2] accept / reject decision, [3] Cholesky
// solve, [4] retraction; those marks slow the kernel.  A mark waits for
// the value it is given, so a phase ends when its result exists.
__device__ long long g_phase[7];
extern "C" int pose_lm_phase_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int pose_lm_phase_reset() {
  const long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  return t;
}
__device__ __forceinline__ long long phase_clock(float dep) {
  long long t;
  asm volatile("{\n\t.reg .pred p;\n\tsetp.eq.f32 p, %1, 0f7F800001;\n\t"
               "mov.u64 %0, %%clock64;\n\t}" : "=l"(t) : "f"(dep) : "memory");
  return t;
}
#define KERNEL_START                                  \
  const long long prof_c0_ = clock64(), prof_ns0_ = global_ns()
#define KERNEL_END(dep)                               \
  do {                                                \
    if (blockIdx.x == 0 && threadIdx.x == 0) {        \
      g_phase[5] += phase_clock(dep) - prof_c0_;      \
      g_phase[6] += global_ns() - prof_ns0_;          \
    }                                                 \
  } while (0)
#else
#define KERNEL_START
#define KERNEL_END(dep) do {} while (0)
#endif
#ifdef POSE_LM_PROFILE
#define PHASE_START                                   \
  const bool prof_ = blockIdx.x == 0 && threadIdx.x == 0; \
  long long prof_t_ = phase_clock(0.0f)
#define PHASE(k, dep)                                 \
  do {                                                \
    if (prof_) {                                      \
      const long long t_ = phase_clock(dep);          \
      g_phase[k] += t_ - prof_t_;                     \
      prof_t_ = t_;                                   \
    }                                                 \
  } while (0)
#else
#define PHASE_START
#define PHASE(k, dep) do {} while (0)
#endif

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// v + w t + qv x t with t = 2 qv x v (core/lie.quat_rotate)
__device__ __forceinline__ void quat_rotate(const float q[4], const float v[3],
                                            float o[3]) {
  const float qv[3] = {q[1], q[2], q[3]};
  float t[3], c[3];
  cross3(qv, v, t);
  t[0] *= 2.0f; t[1] *= 2.0f; t[2] *= 2.0f;
  cross3(qv, t, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = v[i] + q[0] * t[i] + c[i];
}

__device__ __forceinline__ void quat_normalize(float q[4]) {
  const float sq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const float n = fmaxf(sqrtf(fmaxf(sq, 1e-24f)), 1e-8f);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
  if (q[0] < 0.0f)  // canonical sign w >= 0
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
}

// exp(dx) * T (core/lie.se3_retract), dx = [rho, phi]
__device__ __forceinline__ Pose retract(const Pose& T, const float dx[6]) {
  const float* rho = dx;
  const float* phi = dx + 3;
  const float th2s = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float theta = sqrtf(fmaxf(th2s, 1e-24f));
  const float half = 0.5f * theta;
  const float k = theta > 1e-8f ? sinf(half) / fmaxf(theta, 1e-8f) : 0.5f;
  float dq[4] = {cosf(half), k * phi[0], k * phi[1], k * phi[2]};
  quat_normalize(dq);
  const float th2 = theta * theta;
  const bool small = theta < 1e-5f;
  const float a = small ? 0.5f - th2 / 24.0f
                        : (1.0f - cosf(theta)) / fmaxf(th2, 1e-8f);
  const float b = small ? 1.0f / 6.0f - th2 / 120.0f
                        : (theta - sinf(theta)) / fmaxf(th2 * theta, 1e-8f);
  float w1[3], w2[3], dt[3];
  cross3(phi, rho, w1);
  cross3(phi, w1, w2);
#pragma unroll
  for (int i = 0; i < 3; ++i) dt[i] = rho[i] + a * w1[i] + b * w2[i];
  quat_normalize(dq);  // se3(q, t) normalizes again
  Pose out;
  const float* p = T.q;
  out.q[0] = dq[0] * p[0] - dq[1] * p[1] - dq[2] * p[2] - dq[3] * p[3];
  out.q[1] = dq[0] * p[1] + dq[1] * p[0] + dq[2] * p[3] - dq[3] * p[2];
  out.q[2] = dq[0] * p[2] - dq[1] * p[3] + dq[2] * p[0] + dq[3] * p[1];
  out.q[3] = dq[0] * p[3] + dq[1] * p[2] - dq[2] * p[1] + dq[3] * p[0];
  float rt[3];
  quat_rotate(dq, T.t, rt);
#pragma unroll
  for (int i = 0; i < 3; ++i) out.t[i] = rt[i] + dt[i];
  quat_normalize(out.q);
  return out;
}

// (H + lam I) x = -g by Cholesky, H given as its lower triangle h[i(i+1)/2+j]
__device__ __forceinline__ void chol_solve6(const float h[21], const float g[6],
                                            float lam, float x[6]) {
  float L[6][6], inv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = h[i * (i + 1) / 2 + i] + lam;
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * L[i][k];
    L[i][i] = sqrtf(fmaxf(s, 1e-12f));
    inv[i] = 1.0f / L[i][i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) {
      float t = h[j * (j + 1) / 2 + i];
#pragma unroll
      for (int k = 0; k < i; ++k) t -= L[j][k] * L[i][k];
      L[j][i] = t * inv[i];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = -g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

struct Obs {
  float pw[3], u, v, ur, isig;
  bool stereo;
};

struct Consts {
  float fx, fy, cx, cy, bf;
  float chi2_mono, chi2_stereo, delta2_mono, delta2_stereo;
};

// residuals e (third zero for mono), clamped depth z and camera point pc
__device__ __forceinline__ float residual(const Pose& T, const Obs& o,
                                          const Consts& c, float e[3],
                                          float pc[3], float* z) {
  quat_rotate(T.q, o.pw, pc);
#pragma unroll
  for (int i = 0; i < 3; ++i) pc[i] += T.t[i];
  *z = fmaxf(pc[2], 1e-6f);
  const float u = c.fx * pc[0] / *z + c.cx;
  const float v = c.fy * pc[1] / *z + c.cy;
  e[0] = o.u - u;
  e[1] = o.v - v;
  e[2] = o.stereo ? o.ur - (u - c.bf / *z) : 0.0f;
  return (e[0] * e[0] + e[1] * e[1] + e[2] * e[2]) * o.isig;
}

__device__ __forceinline__ float huber(float chi2, float delta2) {
  return chi2 <= delta2 ? 1.0f : sqrtf(delta2 / fmaxf(chi2, 1e-12f));
}

// This thread's share of the normal equations at T (acc[0..21) H, [21..27)
// g, [27] robust cost; [28..32) stay zero).  With `reclass`, first makes the
// active set valid & chi^2 <= threshold at T (the reclassification that
// ends a round).  With `count`, sums the inliers and their chi^2 in acc[0],
// acc[1] instead (the final classification).
template <int PPT>
__device__ __forceinline__ void linearize(const Pose& T, const Obs (&o)[PPT],
                                          const bool (&valid)[PPT],
                                          bool (&act)[PPT], bool reclass,
                                          bool count, bool use_huber,
                                          const Consts& c, float acc[32]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    if (reclass) act[p] = valid[p];
    if (!act[p]) continue;
    float e[3], pc[3], z;
    const float chi2 = residual(T, o[p], c, e, pc, &z);
    if (reclass) {
      act[p] = chi2 <= (o[p].stereo ? c.chi2_stereo : c.chi2_mono);
      if (!act[p]) continue;
    }
    if (count) {
      acc[0] += 1.0f;
      acc[1] += chi2;
      continue;
    }
    const float w = use_huber
        ? huber(chi2, o[p].stereo ? c.delta2_stereo : c.delta2_mono) : 1.0f;
    const float wi = w * o[p].isig;
    const float iz = 1.0f / z, iz2 = iz * iz;
    // rows of d proj / d pc: u, v, and u_R (stereo only)
    const float d[3][3] = {
        {c.fx * iz, 0.0f, -c.fx * pc[0] * iz2},
        {0.0f, c.fy * iz, -c.fy * pc[1] * iz2},
        {o[p].stereo ? c.fx * iz : 0.0f, 0.0f,
         o[p].stereo ? -c.fx * pc[0] * iz2 + c.bf * iz2 : 0.0f}};
    // J = -dproj [I | -hat(pc)]
    float J[3][6];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      J[r][0] = -d[r][0];
      J[r][1] = -d[r][1];
      J[r][2] = -d[r][2];
      J[r][3] = d[r][1] * pc[2] - d[r][2] * pc[1];
      J[r][4] = d[r][2] * pc[0] - d[r][0] * pc[2];
      J[r][5] = d[r][0] * pc[1] - d[r][1] * pc[0];
    }
    int h = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int k = 0; k <= a; ++k, ++h)
        acc[h] += wi * (J[0][a] * J[0][k] + J[1][a] * J[1][k] +
                        J[2][a] * J[2][k]);
      acc[21 + a] += wi * (J[0][a] * e[0] + J[1][a] * e[1] + J[2][a] * e[2]);
    }
    acc[27] += chi2 * w;
  }
}

// One reduce-scatter step over the lane pairs (l, l ^ W): each lane keeps
// the half of v[0..2W) its bit W selects, adds its partner's, in v[0..W).
template <int W>
__device__ __forceinline__ void scatter_step(float v[32], int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, W);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Wait for the phase of parity `parity` of the mbarrier at `bar` to
// complete.  Bounded: a lost exchange traps (the launch fails) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  for (int spin = 0; !ok; ++spin) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (spin > (1 << 24)) __trap();
  }
}

// Sum v[0..NACC) over every thread of the cluster in a fixed order; every
// thread receives the same totals in tot[].  `part` [CLUSTER][WARPS][32] is
// this reduction's buffer and `bar` its mbarrier (callers alternate two;
// `parity` is the buffer's use count mod 2).  Each warp stores its 32 sums
// into every block's copy with st.async, which completes bytes on that
// block's mbarrier; each block waits on its own for all CLUSTER x WARPS x
// 32 values, so no cluster-wide barrier is needed.  A block writes buffer b
// again two reductions later, by which time every block has read it: a
// block's later stores come after its reads of b, and the writer waited
// for them.
__device__ __forceinline__ void cluster_sum(float v[32],
                                            float (*part)[WARPS][32],
                                            uint64_t* bar, uint32_t parity,
                                            int rank, float tot[NACC]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // reduce-scatter: 16 + 8 + 4 + 2 + 1 shuffles; lane j ends with value j
  scatter_step<16>(v, lane);
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
  if constexpr (CLUSTER == 1) {
    part[0][warp][lane] = v[0];
    __syncthreads();
  } else {
    const uint32_t b = smem_u32(bar);
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(b), "r"(CLUSTER * WARPS * 32 * 4) : "memory");
    const uint32_t src = smem_u32(&part[rank][warp][lane]);
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      uint32_t dst, dbar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(dst) : "r"(src), "r"(r));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(dbar) : "r"(b), "r"(r));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
          "[%0], %1, [%2];"
          :: "r"(dst), "r"(__float_as_uint(v[0])), "r"(dbar) : "memory");
    }
    mbar_wait(b, parity);
  }
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r)
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[r][w][lane];
#pragma unroll
  for (int j = 0; j < NACC; ++j) tot[j] = __shfl_sync(FULL, s, j);
}

template <int PPT>
__global__ void __launch_bounds__(THREADS)
pose_lm_kernel(const float* __restrict__ T0, const float* __restrict__ pw,
               const float* __restrict__ uv, const float* __restrict__ ur,
               const float* __restrict__ isig,
               const uint8_t* __restrict__ valid_in,
               const uint8_t* __restrict__ stereo, const float* __restrict__ K,
               float bf, float chi2_mono, float chi2_stereo, float delta2_mono,
               float delta2_stereo, float lam_init, float lam_factor,
               int rounds, int iters, int N, float* __restrict__ T_out,
               uint8_t* __restrict__ inlier, int* __restrict__ n_inlier,
               float* __restrict__ chi2_out, int* __restrict__ n_iter,
               int* __restrict__ count) {
  KERNEL_START;
  // launches, counted on the device (also under graph replay)
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(count, 1);
  __shared__ float part[2][CLUSTER][WARPS][32];
  __shared__ __align__(8) uint64_t bar[2];
  // every block of the cluster must be running, its mbarriers initialized,
  // before the first store into its shared memory: arrive now, wait just
  // before that store
  if constexpr (CLUSTER > 1) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&bar[0])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&bar[1])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  }
  const int rank = CLUSTER > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * N;
  const int per_block = (N + CLUSTER - 1) / CLUSTER;
  const int lo = rank * per_block;
  const int hi = min(lo + per_block, N);
  const Consts c = {K[0], K[1], K[2], K[3], bf,
                    chi2_mono, chi2_stereo, delta2_mono, delta2_stereo};

  // this thread's points, loaded once (neighbouring threads, neighbouring
  // rows)
  Obs o[PPT];
  bool valid[PPT], act[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = lo + tid + p * THREADS;
    valid[p] = false;
    o[p] = Obs{{0.0f, 0.0f, 0.0f}, 0.0f, 0.0f, 0.0f, 0.0f, false};
    if (i < hi) {
      const size_t r = base + i;
      o[p].pw[0] = pw[3 * r];
      o[p].pw[1] = pw[3 * r + 1];
      o[p].pw[2] = pw[3 * r + 2];
      o[p].u = uv[2 * r];
      o[p].v = uv[2 * r + 1];
      o[p].ur = ur[r];
      o[p].isig = isig[r];
      o[p].stereo = stereo[r] != 0;
      valid[p] = valid_in[r] != 0;
    }
    act[p] = valid[p];
  }
  Pose T;
#pragma unroll
  for (int i = 0; i < 4; ++i) T.q[i] = T0[7 * b + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) T.t[i] = T0[7 * b + 4 + i];
  if constexpr (CLUSTER > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");

  // One pass and one reduction per loop turn.  it = -1: the round's first
  // linearization (at T, after reclassifying); it >= 0: LM iteration `it`,
  // its trial pose Tn's cost and normal equations.  rnd == rounds: the
  // final classification.
  float acc[32], tot[NACC], Hg[NACC];
  Pose Tn = T;
  float lam = lam_init, dx2 = 0.0f;
  int red = 0, n_it = 0, rnd = 0, it = -1;
  PHASE_START;
  while (true) {
    const bool start = it < 0, fin = rnd == rounds;
    linearize<PPT>(start ? T : Tn, o, valid, act, fin || (start && rnd > 0),
                   fin, rnd < rounds - 1, c, acc);
    PHASE(0, acc[27]);
    cluster_sum(acc, part[red & 1], &bar[red & 1], (red >> 1) & 1, rank,
                tot);
    PHASE(1, tot[27]);
    ++red;
    if (fin) break;
    // every thread: accept / reject, damping, convergence
    if (start) {
      lam = lam_init;
#pragma unroll
      for (int j = 0; j < NACC; ++j) Hg[j] = tot[j];
    } else {
      bool finite = true;
#pragma unroll
      for (int i = 0; i < 4; ++i) finite = finite && isfinite(Tn.q[i]);
#pragma unroll
      for (int i = 0; i < 3; ++i) finite = finite && isfinite(Tn.t[i]);
      const float total0 = Hg[27], total1 = tot[27];
      const bool ok = (total1 < total0) && finite;
      lam = fminf(fmaxf(ok ? lam * 0.5f : lam * lam_factor, 1e-10f), 1e6f);
      const float rel = (total0 - total1) / fmaxf(total0, 1e-9f);
      n_it += 1;
      if (ok) {
        T = Tn;
#pragma unroll
        for (int j = 0; j < NACC; ++j) Hg[j] = tot[j];
      }
      if (ok && rel < 1e-5f && dx2 < 1e-10f) it = iters - 1;  // converged
    }
    PHASE(2, Hg[27] + lam);
    if (++it >= iters) {  // round over
      ++rnd;
      it = -1;
      continue;
    }
    // every thread: solve, retract
    float dx[6];
    chol_solve6(Hg, Hg + 21, lam, dx);
    PHASE(3, dx[0] + dx[5]);
    Tn = retract(T, dx);
    PHASE(4, Tn.q[0] + Tn.t[2]);
    dx2 = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) dx2 += dx[i] * dx[i];
  }

#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = lo + tid + p * THREADS;
    if (i < hi) inlier[base + i] = act[p];
  }
  if (rank == 0 && tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) T_out[7 * b + i] = T.q[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) T_out[7 * b + 4 + i] = T.t[i];
    n_inlier[b] = (int)tot[0];
    chi2_out[b] = tot[1];
    n_iter[b] = n_it;
  }
  KERNEL_END(tot[0]);
  // no block reads another's shared memory, and every store into this
  // block's arrived before its last wait returned: no final barrier
}

template <int PPT>
static cudaError_t launch(const float* T0, const float* pw, const float* uv,
                          const float* ur, const float* isig,
                          const uint8_t* valid, const uint8_t* stereo,
                          const float* K, float bf, float chi2_mono,
                          float chi2_stereo, float delta2_mono,
                          float delta2_stereo, float lam_init,
                          float lam_factor, int rounds, int iters, int B,
                          int N, float* T_out, uint8_t* inlier, int* n_inlier,
                          float* chi2_out, int* n_iter, int* count,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, pose_lm_kernel<PPT>, T0, pw, uv, ur, isig,
                            valid, stereo, K, bf, chi2_mono, chi2_stereo,
                            delta2_mono, delta2_stereo, lam_init, lam_factor,
                            rounds, iters, N, T_out, inlier, n_inlier,
                            chi2_out, n_iter, count);
}

// The largest N one launch takes, and the cluster size it was built with.
extern "C" int pose_lm_max_points() { return MAX_PPT * THREADS * CLUSTER; }
extern "C" int pose_lm_cluster() { return CLUSTER; }

// C interface for ctypes: launches one cluster of CLUSTER blocks per
// problem on `stream`, adds 1 to `count` (device memory, or null), returns
// the launch's error (cudaErrorInvalidValue for N above
// pose_lm_max_points()).
extern "C" int pose_lm_launch(
    const float* T0, const float* pw, const float* uv, const float* ur,
    const float* isig, const uint8_t* valid, const uint8_t* stereo,
    const float* K, float bf, float chi2_mono, float chi2_stereo,
    float delta2_mono, float delta2_stereo, float lam_init, float lam_factor,
    int rounds, int iters, int B, int N, float* T_out, uint8_t* inlier,
    int* n_inlier, float* chi2_out, int* n_iter, int* count, void* stream) {
  const int ppt = ((N + CLUSTER - 1) / CLUSTER + THREADS - 1) / THREADS;
  cudaError_t err;
#define POSE_LM_ARGS                                                         \
  T0, pw, uv, ur, isig, valid, stereo, K, bf, chi2_mono, chi2_stereo,        \
      delta2_mono, delta2_stereo, lam_init, lam_factor, rounds, iters, B, N, \
      T_out, inlier, n_inlier, chi2_out, n_iter, count, (cudaStream_t)stream
  if (ppt <= 1)
    err = launch<1>(POSE_LM_ARGS);
  else if (ppt <= 2)
    err = launch<2>(POSE_LM_ARGS);
  else if (ppt <= 4)
    err = launch<4>(POSE_LM_ARGS);
  else if (ppt <= MAX_PPT)
    err = launch<MAX_PPT>(POSE_LM_ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef POSE_LM_ARGS
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
