// K4: weighted coordinate moments of [B, K, H, W] maps.
//
// Replaces ops/pallas/normal_eq.py::weighted_moments (_moment_kernel), which
// contracts each row tile with x- and y-power matrices on the MXU and
// carries the sum across sequential grid steps.
//
// Bound on the H100: reading the maps once (K * H * W * 4 bytes per pair,
// 3 planes of 388 x 584 at the flagship's finest level = 2.7 MB per pair)
// against 3.35 TB/s; the 5 multiply-adds per pixel and map are far below
// the FP32 rate. Design: one block per (pair, tile of WARPS rows); each warp
// walks one row with coalesced loads, keeps 5 x-power sums per map in
// registers, reduces them across the warp, and weights them by the row's
// y powers (common.cuh). The per-block partials are summed in a fixed order
// by a second small kernel.
#include "common.cuh"

namespace ica {

__global__ void __launch_bounds__(THREADS)
weighted_moments_kernel(const float* __restrict__ maps, float* __restrict__ partial,
                        int K, int H, int W, float inv_l, int ntiles) {
  __shared__ float row_buf[WARPS][MAXK * DEG];
  __shared__ float blk_buf[WARPS * MAXK * NMOM];
  const int pair = blockIdx.y, tile = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = tile * WARPS + warp;
  float acc[DEG] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (row < H) {
    float wx[MAXK][DEG] = {};
    const int64_t plane = (int64_t)H * W;
    const float* base = maps + (int64_t)pair * K * plane + (int64_t)row * W;
    for (int x = lane; x < W; x += 32) {
      float m[MAXK];
#pragma unroll
      for (int k = 0; k < MAXK; ++k) m[k] = k < K ? base[k * plane + x] : 0.0f;
      accumulate_pixel(wx, m, K, (float)x * inv_l);
    }
    finish_row(wx, K, (float)row * inv_l, row_buf[warp], acc, lane);
  }
  finish_block(acc, K, blk_buf, partial, pair, ntiles, tile, warp, lane);
}

__global__ void finalize_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                int bk, int ntiles) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= bk * 64) return;
  const int pk = idx / 64, j = (idx % 64) / 8, i = idx % 8;
  float s = 0.0f;
  if (j < DEG && i < DEG) {
    const float* p = partial + (int64_t)pk * ntiles * NMOM + j * DEG + i;
    for (int t = 0; t < ntiles; ++t) s += p[(int64_t)t * NMOM];
  }
  out[idx] = s;
}

cudaError_t launch_finalize(const float* partial, float* out, int bk, int ntiles,
                            cudaStream_t stream) {
  const int n = bk * 64;
  finalize_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, out, bk, ntiles);
  return cudaGetLastError();
}

}  // namespace ica

// maps [B, K, H, W] f32 (K <= 5) -> out [B, K, 8, 8]; partial is scratch of
// B * K * ceil(H / 8) * 25 floats.
extern "C" int ica_weighted_moments(const float* maps, float* partial, float* out, int B,
                                    int K, int H, int W, float inv_l, void* stream) {
  using namespace ica;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (H + WARPS - 1) / WARPS;
  weighted_moments_kernel<<<dim3(ntiles, B), THREADS, 0, s>>>(maps, partial, K, H, W,
                                                              inv_l, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_finalize(partial, out, B * K, ntiles, s);
}

extern "C" const char* ica_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
