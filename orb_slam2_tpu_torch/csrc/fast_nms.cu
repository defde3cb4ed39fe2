// Fused FAST-9 corner score + 3x3 non-maximum suppression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel orb_slam2_tpu/frontend/pallas_fast.py
// (_make_kernel, launched by _run).  Computes, for one [H, W] f32 pyramid
// level, the same two maps as `nms3x3(fast_score_map(img))` in
// orb_slam2_tpu_torch/frontend/fast.py:
//   raw[y, x] = max(max_r min_{k<9}(c[r+k] - p), max_r min_{k<9}(p - c[r+k]), 0)
//               over the 16 rotations r of the radius-3 Bresenham circle c,
//               zero within 3 px of the level's own edge;
//   nms[y, x] = raw[y, x] if raw[y, x] >= all 8 neighbours, else 0.
// Both are min/max of differences of f32 values, so the result is bit-exact
// with the plain PyTorch version.
//
// Design: one block per 32x32 output tile.  The tile plus a 4-px halo
// (3 for the circle, 1 for the NMS ring) is staged in shared memory; the raw
// score of the tile plus a 1-px ring is computed into shared memory with the
// border zeroed at H, W; then the NMS reads its 3x3 neighbourhood from there
// and both outputs are written once.  The TPU kernel's 64-row tiling with
// three overlapping BlockSpec inputs is not carried over: blocks here load
// their own halo.
//
// Bound on the H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32): per 640x480 frame the
// 8 levels hold 950,532 px; the kernel reads 4 B and writes 8 B per pixel,
// ~11.4 MB, ~3.4 us of memory time.  The arc test costs ~350 f32 min/max a
// pixel, ~3.3e8 a frame, ~5 us of FP32 issue — so the work is bound by
// operations, and at these sizes 8 separate launches (one per level) are
// bound by launch latency.  Making it fast (one launch for all levels, a
// cheaper sliding-minimum arc test) is later work.

#include <cuda_runtime.h>
#include <math.h>

#define TILE_W 32
#define TILE_H 32
#define HALO 4
#define SW (TILE_W + 2 * HALO)
#define SH (TILE_H + 2 * HALO)
#define RW (TILE_W + 2)
#define RH (TILE_H + 2)

__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__global__ void fast_nms_kernel(const float* __restrict__ img,
                                float* __restrict__ nms,
                                float* __restrict__ raw, int H, int W) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_raw[RH][RW];
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // 1. image tile + 4-px halo (outside the image: 0, never read unmasked)
  for (int i = tid; i < SH * SW; i += nthreads) {
    const int ly = i / SW, lx = i % SW;
    const int gy = y0 + ly - HALO, gx = x0 + lx - HALO;
    s_img[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                        ? img[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  // 2. raw FAST-9 score of the tile + 1-px ring
  for (int i = tid; i < RH * RW; i += nthreads) {
    const int ly = i / RW, lx = i % RW;
    const int gy = y0 + ly - 1, gx = x0 + lx - 1;
    float s = 0.0f;
    if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3) {
      const int cy = ly + HALO - 1, cx = lx + HALO - 1;
      const float p = s_img[cy][cx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = s_img[cy + c_dy[k]][cx + c_dx[k]] - p;
      float bright = -INFINITY, dark = -INFINITY;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        float mb = d[r], md = -d[r];
#pragma unroll
        for (int k = 1; k < 9; ++k) {
          const float v = d[(r + k) & 15];
          mb = fminf(mb, v);
          md = fminf(md, -v);
        }
        bright = fmaxf(bright, mb);
        dark = fmaxf(dark, md);
      }
      s = fmaxf(fmaxf(bright, dark), 0.0f);
    }
    s_raw[ly][lx] = s;
  }
  __syncthreads();

  // 3. 3x3 NMS on the tile; write both maps
  for (int i = tid; i < TILE_H * TILE_W; i += nthreads) {
    const int ly = i / TILE_W, lx = i % TILE_W;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const float s = s_raw[ly + 1][lx + 1];
    float m = s_raw[ly][lx];
    m = fmaxf(m, s_raw[ly][lx + 1]);
    m = fmaxf(m, s_raw[ly][lx + 2]);
    m = fmaxf(m, s_raw[ly + 1][lx]);
    m = fmaxf(m, s_raw[ly + 1][lx + 2]);
    m = fmaxf(m, s_raw[ly + 2][lx]);
    m = fmaxf(m, s_raw[ly + 2][lx + 1]);
    m = fmaxf(m, s_raw[ly + 2][lx + 2]);
    const size_t o = (size_t)gy * W + gx;
    raw[o] = s;
    nms[o] = (s >= m) ? s : 0.0f;
  }
}

// C interface for ctypes: launches on `stream`, returns cudaGetLastError().
extern "C" int fast_nms_launch(const float* img, float* nms, float* raw,
                               int H, int W, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
  fast_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, nms, raw, H, W);
  return (int)cudaGetLastError();
}
