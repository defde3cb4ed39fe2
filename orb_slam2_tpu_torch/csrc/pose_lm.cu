// Motion-only pose optimization (the whole 4 x 10 Levenberg-Marquardt
// schedule) for Hopper (sm_90a), one thread block per problem.
//
// Replaces the Pallas TPU kernel scripts/study_pallas_pose.py (_make_kernel,
// launched by _run; pose_optimize_pallas is its drop-in for
// solvers/pose_opt.pose_optimize).  Computes, for each of B problems, the
// function of pose_optimize_plain in orb_slam2_tpu_torch/solvers/pose_opt.py
// (reference Optimizer::PoseOptimization): `rounds` rounds of up to `iters`
// LM iterations over one SE3 pose against fixed points, Huber IRLS weights
// in every round but the last, analytic Jacobians of the left-multiplied
// exp map, the 6x6 normal equations solved by Cholesky (pivots clamped as
// sqrt(max(s, 1e-12)), as the TPU kernel), left-exp retraction, accept when
// the robust cost drops and the new pose is finite, lambda x0.5 on accept and
// x lam_factor on reject clipped to [1e-10, 1e6], and chi^2 inlier
// reclassification after each round (chi2_mono / chi2_stereo).
//
// Convergence stop: a round ends early once an accepted step changed the
// robust cost by < 1e-5 relative AND moved the pose by |dx|^2 < 1e-10 — the
// JAX main path's while_loop (orb_slam2_tpu/solvers/pose_opt.py:122-128).
// The TPU study kernel runs all iterations; after that stop they are no-ops.
//
// Per iteration every thread accumulates its points' 21 H entries, 6 g
// entries and the cost in registers; a block reduction sums them (butterfly
// warp shuffles, then the 8 warp partials in shared memory added in warp
// order) with no atomics, so two launches give bit-identical results.  One
// thread solves and retracts; a second pass reduces the new pose's cost;
// the accept flag, pose, lambda and stop flag are broadcast through shared
// memory.  Inactive rows are skipped (the plain version multiplies them by
// zero).  Mono rows have ur = -1 and a zero third residual.  All FP32
// scalar arithmetic: no tensor cores, so TF32 does not arise.
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32): at N = 1024 a problem
// reads ~31 KB (~10 ns) and does at most ~1.4e7 f32 operations (~0.2 us).
// The real limit is the serial chain: 2 block reductions, a 6x6 Cholesky on
// one thread and 5 barriers per iteration, up to 40 iterations, on one SM.
// A block per problem fills 1 (tracking) or 4 (relocalisation) of 132 SMs;
// making the chain shorter (warp-level solves, fewer barriers, several
// problems per launch from tracking) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define NACC 28  // 21 H (lower triangle) + 6 g + cost

struct Pose {
  float q[4];
  float t[3];
};

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
  for (int i = 0; i < 3; ++i) o[i] = v[i] + q[0] * t[i] + c[i];
}

__device__ __forceinline__ void quat_normalize(float q[4]) {
  const float sq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const float n = fmaxf(sqrtf(fmaxf(sq, 1e-24f)), 1e-8f);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
  if (q[0] < 0.0f)  // canonical sign w >= 0
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
}

// exp(dx) * T (core/lie.se3_retract), dx = [rho, phi]
__device__ Pose retract(const Pose& T, const float dx[6]) {
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
  for (int i = 0; i < 3; ++i) out.t[i] = rt[i] + dt[i];
  quat_normalize(out.q);
  return out;
}

// (H + lam I) x = -g by Cholesky, H given as its lower triangle h[i(i+1)/2+j]
__device__ void chol_solve6(const float h[21], const float g[6], float lam,
                            float x[6]) {
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    float s = h[i * (i + 1) / 2 + i] + lam;
    for (int k = 0; k < i; ++k) s -= L[i][k] * L[i][k];
    L[i][i] = sqrtf(fmaxf(s, 1e-12f));
    const float inv = 1.0f / L[i][i];
    for (int j = i + 1; j < 6; ++j) {
      float t = h[j * (j + 1) / 2 + i];
      for (int k = 0; k < i; ++k) t -= L[j][k] * L[i][k];
      L[j][i] = t * inv;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = -g[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

struct Obs {
  float pw[3], u, v, ur, isig;
  bool stereo;
};

struct Cam {
  float fx, fy, cx, cy, bf;
};

// residuals e (third zero for mono), clamped depth z and camera point pc
__device__ __forceinline__ float residual(const Pose& T, const Obs& o,
                                          const Cam& c, float e[3],
                                          float pc[3], float* z) {
  quat_rotate(T.q, o.pw, pc);
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

// Sum v[0..n) over the block in a fixed order; the totals land in out[].
template <int n>
__device__ __forceinline__ void block_sum(float v[n], float (*part)[NACC], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < n; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  }
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < n; ++j) part[warp][j] = v[j];
  __syncthreads();
  if (threadIdx.x < n) {
    float s = part[0][threadIdx.x];
    for (int w = 1; w < WARPS; ++w) s += part[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
pose_lm_kernel(const float* __restrict__ T0, const float* __restrict__ pw,
               const float* __restrict__ uv, const float* __restrict__ ur,
               const float* __restrict__ isig,
               const uint8_t* __restrict__ valid,
               const uint8_t* __restrict__ stereo, const float* __restrict__ K,
               float bf, float chi2_mono, float chi2_stereo, float delta2_mono,
               float delta2_stereo, float lam_init, float lam_factor,
               int rounds, int iters, int N, float* __restrict__ T_out,
               uint8_t* __restrict__ inlier, int* __restrict__ n_inlier,
               float* __restrict__ chi2_out, int* __restrict__ n_iter) {
  __shared__ float part[WARPS][NACC];
  __shared__ float tot[NACC];
  __shared__ Pose s_T, s_Tnew;
  __shared__ float s_lam, s_dx2, s_cost1[1];
  __shared__ int s_done, s_iters;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * N;
  const Cam cam = {K[0], K[1], K[2], K[3], bf};
  uint8_t* act = inlier + base;  // the active set lives in the output mask

  auto load = [&](int i) {
    Obs o;
    const size_t r = base + i;
    o.pw[0] = pw[3 * r];
    o.pw[1] = pw[3 * r + 1];
    o.pw[2] = pw[3 * r + 2];
    o.u = uv[2 * r];
    o.v = uv[2 * r + 1];
    o.ur = ur[r];
    o.isig = isig[r];
    o.stereo = stereo[r] != 0;
    return o;
  };

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) s_T.q[i] = T0[7 * b + i];
    for (int i = 0; i < 3; ++i) s_T.t[i] = T0[7 * b + 4 + i];
    s_iters = 0;
  }
  for (int i = tid; i < N; i += THREADS) act[i] = valid[base + i];
  __syncthreads();

  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool use_huber = rnd < rounds - 1;
    if (tid == 0) {
      s_lam = lam_init;
      s_done = 0;
    }
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      const Pose T = s_T;
      // 1. normal equations at T
      float acc[NACC];
#pragma unroll
      for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;
      for (int i = tid; i < N; i += THREADS) {
        if (!act[i]) continue;
        const Obs o = load(i);
        float e[3], pc[3], z;
        const float chi2 = residual(T, o, cam, e, pc, &z);
        const float w = use_huber
            ? huber(chi2, o.stereo ? delta2_stereo : delta2_mono) : 1.0f;
        const float wi = w * o.isig;
        const float iz = 1.0f / z, iz2 = iz * iz;
        // rows of d proj / d pc: u, v, and u_R (stereo only)
        const float d[3][3] = {
            {cam.fx * iz, 0.0f, -cam.fx * pc[0] * iz2},
            {0.0f, cam.fy * iz, -cam.fy * pc[1] * iz2},
            {o.stereo ? cam.fx * iz : 0.0f, 0.0f,
             o.stereo ? -cam.fx * pc[0] * iz2 + bf * iz2 : 0.0f}};
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
          for (int c = 0; c <= a; ++c, ++h)
            acc[h] += wi * (J[0][a] * J[0][c] + J[1][a] * J[1][c] +
                            J[2][a] * J[2][c]);
          acc[21 + a] += wi * (J[0][a] * e[0] + J[1][a] * e[1] +
                               J[2][a] * e[2]);
        }
        acc[27] += chi2 * w;
      }
      block_sum<NACC>(acc, part, tot);
      // 2. one thread solves and retracts
      if (tid == 0) {
        float dx[6];
        chol_solve6(tot, tot + 21, s_lam, dx);
        s_Tnew = retract(T, dx);
        float dx2 = 0.0f;
        for (int i = 0; i < 6; ++i) dx2 += dx[i] * dx[i];
        s_dx2 = dx2;
      }
      __syncthreads();
      // 3. robust cost at the new pose
      const Pose Tn = s_Tnew;
      float c1[1] = {0.0f};
      for (int i = tid; i < N; i += THREADS) {
        if (!act[i]) continue;
        const Obs o = load(i);
        float e[3], pc[3], z;
        const float chi2 = residual(Tn, o, cam, e, pc, &z);
        c1[0] += chi2 * (use_huber
            ? huber(chi2, o.stereo ? delta2_stereo : delta2_mono) : 1.0f);
      }
      block_sum<1>(c1, part, s_cost1);
      // 4. accept / reject, damping, convergence
      if (tid == 0) {
        const float total0 = tot[27], total1 = s_cost1[0];
        bool finite = true;
        for (int i = 0; i < 4; ++i) finite = finite && isfinite(Tn.q[i]);
        for (int i = 0; i < 3; ++i) finite = finite && isfinite(Tn.t[i]);
        const bool ok = (total1 < total0) && finite;
        if (ok) s_T = Tn;
        s_lam = fminf(fmaxf(ok ? s_lam * 0.5f : s_lam * lam_factor, 1e-10f),
                      1e6f);
        const float rel = (total0 - total1) / fmaxf(total0, 1e-9f);
        s_done = ok && rel < 1e-5f && s_dx2 < 1e-10f;
        s_iters += 1;
      }
      __syncthreads();
      if (s_done) break;
    }
    // 5. reclassify: active = valid & chi2 <= threshold
    const Pose T = s_T;
    for (int i = tid; i < N; i += THREADS) {
      const Obs o = load(i);
      float e[3], pc[3], z;
      const float chi2 = residual(T, o, cam, e, pc, &z);
      act[i] = valid[base + i] &&
               chi2 <= (o.stereo ? chi2_stereo : chi2_mono);
    }
    __syncthreads();
  }

  // final classification at the optimized pose (the last round's)
  const Pose T = s_T;
  float fin[2] = {0.0f, 0.0f};
  for (int i = tid; i < N; i += THREADS) {
    const Obs o = load(i);
    float e[3], pc[3], z;
    const float chi2 = residual(T, o, cam, e, pc, &z);
    const bool in = valid[base + i] &&
                    chi2 <= (o.stereo ? chi2_stereo : chi2_mono);
    act[i] = in;
    if (in) {
      fin[0] += 1.0f;
      fin[1] += chi2;
    }
  }
  block_sum<2>(fin, part, tot);
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) T_out[7 * b + i] = T.q[i];
    for (int i = 0; i < 3; ++i) T_out[7 * b + 4 + i] = T.t[i];
    n_inlier[b] = (int)tot[0];
    chi2_out[b] = tot[1];
    n_iter[b] = s_iters;
  }
}

// C interface for ctypes: launches one block per problem on `stream`,
// returns cudaGetLastError().
extern "C" int pose_lm_launch(
    const float* T0, const float* pw, const float* uv, const float* ur,
    const float* isig, const uint8_t* valid, const uint8_t* stereo,
    const float* K, float bf, float chi2_mono, float chi2_stereo,
    float delta2_mono, float delta2_stereo, float lam_init, float lam_factor,
    int rounds, int iters, int B, int N, float* T_out, uint8_t* inlier,
    int* n_inlier, float* chi2_out, int* n_iter, void* stream) {
  pose_lm_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      T0, pw, uv, ur, isig, valid, stereo, K, bf, chi2_mono, chi2_stereo,
      delta2_mono, delta2_stereo, lam_init, lam_factor, rounds, iters, N,
      T_out, inlier, n_inlier, chi2_out, n_iter);
  return (int)cudaGetLastError();
}
