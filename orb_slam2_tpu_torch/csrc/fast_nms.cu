// Fused FAST-9 corner score + 3x3 non-maximum suppression for Hopper
// (sm_90a), every pyramid level of every image in one launch.
//
// Replaces the Pallas TPU kernel orb_slam2_tpu/frontend/pallas_fast.py
// (_make_kernel, launched by _run once per level).  Reads the zero-padded
// level atlas [G, Hp, Wp] f32 (G = n_images * L, image-major, level g % L of
// shape h[g % L] x w[g % L] in the top-left corner of its plane) and writes
// two maps of the same shape, zero outside each level — exactly what
// `torch.stack([pad(s) for s in per-level maps])` gives, with per level the
// maps of `nms3x3(fast_score_map(level))` (orb_slam2_tpu_torch/frontend/
// fast.py):
//   raw[y, x] = max(max_r min_{k<9}(c[r+k] - p), max_r min_{k<9}(p - c[r+k]), 0)
//               over the 16 rotations r of the radius-3 Bresenham circle c,
//               zero within 3 px of the level's own edge;
//   nms[y, x] = raw[y, x] if raw[y, x] >= all 8 neighbours, else 0, a
//               neighbour outside the level counting as 0 (the plain
//               version's wrap lands in the zero border).
// Pixels of the atlas outside a level are never read.
//
// The arc test takes the minima of the 16 circular windows of 9 over
// d = c - p by van Herk / Gil-Werman block prefix and suffix minima (44
// min), bright = their max (15); dark = -min_r max9(d)[r] the same way on
// maxima, since min(-v) = -max(v): 59 operations an arc, where doubling
// minima (m2, m4, m8, then the 9th) take 79.  min, max and negation are
// exact in f32, so both maps are bit-exact with the plain version (up to
// the sign of a zero).
//
// Design: a grid of 32x32 output tiles over each plane of the atlas; blockIdx.z
// is the plane.  A tile that lies wholly outside its level only writes zeros.
// Any other stages its pixels plus a 4-px halo (3 for the circle, 1 for the
// NMS ring) in shared memory, computes the raw score of the tile plus a 1-px
// ring into shared memory, then the NMS, and writes both maps once.  The TPU
// kernel's 64-row tiling with three overlapping BlockSpec inputs is not
// carried over: blocks load their own halo.
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32): per 640x480 frame the
// 8 levels hold 950,532 px read once (3.8 MB) and the two padded outputs are
// 2 x 8 x 480 x 640 x 4 B = 19.7 MB written once: ~7.0 us of memory time;
// 145 f32 operations a pixel (16 differences, 2 x (44 + 15) min/max, 2 max,
// 9 NMS), 1.38e8 a frame, ~2.1 us of FP32 issue — bound by bytes.

#include <cuda_runtime.h>
#include <math.h>

#define TILE_W 32
#define TILE_H 32
#define HALO 4
#define SW (TILE_W + 2 * HALO)
#define SH (TILE_H + 2 * HALO)
#define RW (TILE_W + 2)
#define RH (TILE_H + 2)
#define NT 256
#define MAX_LEVELS 32

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

// the radius-3 Bresenham circle, clockwise from the top (frontend/fast.py
// CIRCLE): offsets are literals, so each read is one shared load at an
// immediate offset
#define CIRCLE_DIFFS(d, s, cy, cx, p)                                       \
  do {                                                                      \
    d[0] = s[cy - 3][cx] - p;      d[1] = s[cy - 3][cx + 1] - p;            \
    d[2] = s[cy - 2][cx + 2] - p;  d[3] = s[cy - 1][cx + 3] - p;            \
    d[4] = s[cy][cx + 3] - p;      d[5] = s[cy + 1][cx + 3] - p;            \
    d[6] = s[cy + 2][cx + 2] - p;  d[7] = s[cy + 3][cx + 1] - p;            \
    d[8] = s[cy + 3][cx] - p;      d[9] = s[cy + 3][cx - 1] - p;            \
    d[10] = s[cy + 2][cx - 2] - p; d[11] = s[cy + 1][cx - 3] - p;           \
    d[12] = s[cy][cx - 3] - p;     d[13] = s[cy - 1][cx - 3] - p;           \
    d[14] = s[cy - 2][cx - 2] - p; d[15] = s[cy - 3][cx - 1] - p;           \
  } while (0)

// Windows of 9 on the circle of 16 by van Herk / Gil-Werman: on the
// unrolled e[i] = d[i % 16], i < 24, cut in blocks [0, 9), [9, 18),
// [18, 24), the window [r, r + 8] is min(S[r], P[r + 8]) with S the suffix
// minima within r's block and P the prefix minima within r + 8's block.
// IN is the window's operation (min for the bright arc, max for the dark
// one) and OUT the one over the 16 windows; 44 + 15 operations.
template <bool BRIGHT>
__device__ __forceinline__ float arc9(const float d[16]) {
  auto in = [](float a, float b) { return BRIGHT ? fminf(a, b) : fmaxf(a, b); };
  auto out = [](float a, float b) { return BRIGHT ? fmaxf(a, b) : fminf(a, b); };
  float S[16], P[16];  // S[r], r < 16; P[j - 8], 8 < j < 24
  S[8] = d[8];
#pragma unroll
  for (int r = 7; r >= 0; --r) S[r] = in(d[r], S[r + 1]);
  float t = in(d[0], d[1]);  // e[16], e[17]
#pragma unroll
  for (int r = 15; r >= 9; --r) S[r] = t = in(d[r], t);
  P[1] = d[9];               // j = 9
#pragma unroll
  for (int j = 10; j < 18; ++j) P[j - 8] = in(P[j - 9], d[j & 15]);
  P[10] = d[2];              // j = 18
#pragma unroll
  for (int j = 19; j < 24; ++j) P[j - 8] = in(P[j - 9], d[j & 15]);
  float best = S[0];         // the window [0, 8] is block 0
#pragma unroll
  for (int r = 1; r < 16; ++r) best = out(best, in(S[r], P[r]));
  return best;
}

__global__ void __launch_bounds__(NT)
fast_nms_atlas_kernel(const float* __restrict__ atlas, float* __restrict__ nms,
                      float* __restrict__ raw, const Levels lv, int L, int Hp,
                      int Wp, int* __restrict__ count) {
  // launches and planes covered, counted on the device (also under graph
  // replay); one thread of the launch adds
  if (count != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    atomicAdd(count, 1);
    atomicAdd(count + 1, (int)gridDim.z);
  }
  __shared__ float s_img[SH][SW];
  __shared__ float s_raw[RH][RW];
  const int g = blockIdx.z;
  const int H = lv.h[g % L], W = lv.w[g % L];
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int tx = threadIdx.x, ty = threadIdx.y;  // a (32, 8) block
  const size_t plane = (size_t)g * Hp * Wp;
  const float* img = atlas + plane;

  if (y0 >= H || x0 >= W) {  // wholly outside the level: zeros
    const int gx = x0 + tx;
    for (int gy = y0 + ty; gy < min(y0 + TILE_H, Hp); gy += 8) {
      if (gx < Wp) {
        const size_t o = plane + (size_t)gy * Wp + gx;
        raw[o] = 0.0f;
        nms[o] = 0.0f;
      }
    }
    return;
  }

  // 1. level tile + 4-px halo (outside the level: 0, never read unmasked)
  for (int ly = ty; ly < SH; ly += 8) {
    for (int lx = tx; lx < SW; lx += 32) {
      const int gy = y0 + ly - HALO, gx = x0 + lx - HALO;
      s_img[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                          ? img[(size_t)gy * Wp + gx] : 0.0f;
    }
  }
  __syncthreads();

  // 2. raw FAST-9 score of the tile + 1-px ring
  for (int i = ty * 32 + tx; i < RH * RW; i += NT) {
    const int ly = i / RW, lx = i - ly * RW;
    const int gy = y0 + ly - 1, gx = x0 + lx - 1;
    float s = 0.0f;
    if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3) {
      const int cy = ly + HALO - 1, cx = lx + HALO - 1;
      const float p = s_img[cy][cx];
      float d[16];
      CIRCLE_DIFFS(d, s_img, cy, cx, p);
      const float bright = arc9<true>(d);
      const float dark = -arc9<false>(d);
      s = fmaxf(fmaxf(bright, dark), 0.0f);
    }
    s_raw[ly][lx] = s;
  }
  __syncthreads();

  // 3. 3x3 NMS on the tile; write both maps (zero outside the level)
  for (int ly = ty; ly < TILE_H; ly += 8) {
    const int lx = tx;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= Hp || gx >= Wp) continue;
    const size_t o = plane + (size_t)gy * Wp + gx;
    if (gy >= H || gx >= W) {
      raw[o] = 0.0f;
      nms[o] = 0.0f;
      continue;
    }
    const float s = s_raw[ly + 1][lx + 1];
    float m = s_raw[ly][lx];
    m = fmaxf(m, s_raw[ly][lx + 1]);
    m = fmaxf(m, s_raw[ly][lx + 2]);
    m = fmaxf(m, s_raw[ly + 1][lx]);
    m = fmaxf(m, s_raw[ly + 1][lx + 2]);
    m = fmaxf(m, s_raw[ly + 2][lx]);
    m = fmaxf(m, s_raw[ly + 2][lx + 1]);
    m = fmaxf(m, s_raw[ly + 2][lx + 2]);
    raw[o] = s;
    nms[o] = (s >= m) ? s : 0.0f;
  }
}

extern "C" int fast_nms_max_levels() { return MAX_LEVELS; }

// C interface for ctypes: `hw` holds the L level heights then the L level
// widths (host memory, read here: the launch takes them by value); `count`
// (device memory, or null) gains 1 launch and G planes; launches on
// `stream`, returns cudaGetLastError().
extern "C" int fast_nms_atlas_launch(const float* atlas, float* nms,
                                     float* raw, const int* hw, int L, int G,
                                     int Hp, int Wp, int* count,
                                     void* stream) {
  if (L < 1 || L > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int i = 0; i < L; ++i) {
    lv.h[i] = hw[i];
    lv.w[i] = hw[L + i];
  }
  const dim3 grid((Wp + TILE_W - 1) / TILE_W, (Hp + TILE_H - 1) / TILE_H, G);
  fast_nms_atlas_kernel<<<grid, dim3(32, NT / 32), 0, (cudaStream_t)stream>>>(
      atlas, nms, raw, lv, L, Hp, Wp, count);
  return (int)cudaGetLastError();
}
