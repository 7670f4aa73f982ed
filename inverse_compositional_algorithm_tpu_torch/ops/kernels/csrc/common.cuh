// Device code shared by the alignment kernels (fused_iter.cu, warp_planar.cu,
// weighted_moments.cu) and the benchmark's warp floor (warp_floor.cu).
//
// * bicubic_setup / bicubic_eval: the Keys (a = -0.5) bicubic sampler with
//   Neumann (clip-to-edge) taps. Replaces the TPU's shared tile core
//   ops/pallas/tile_warp.py::warp_tile (+ keys_eval), whose fast/general
//   tiers only exist to express gathers through TPU lane shuffles; here each
//   thread reads its 16 taps straight from device memory through the
//   read-only cache, with the semantics of ops/warp.py::bicubic_sample.
// * accumulate_pixel / finish_row / finish_block / launch_finalize: the
//   coordinate-moment epilogue M_k[b][a] = sum_p w_k(p) (x/L)^a (y/L)^b,
//   a, b < 5, shared by the fused iteration (K1) and the moment kernel (K4).
//   The TPU kernels carry the sum across sequential grid steps; CUDA blocks
//   run in parallel in no order, so every block writes a partial [K][5][5]
//   and a second kernel adds the partials in a fixed order: no atomics, and
//   runs repeat bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ica {

constexpr int DEG = 5;          // moment powers 0..4
constexpr int MAXK = 5;         // moment maps per pair
constexpr int WARPS = 8;        // warps per block; each warp owns one image row
constexpr int THREADS = WARPS * 32;
constexpr int NMOM = DEG * DEG;

// Keys weights of the taps at floor-1 .. floor+2 for fractional offset t
// (ops/warp.py::keys_cubic_weights).
__device__ __forceinline__ void keys_weights(float t, float w[4]) {
  const float t2 = t * t, t3 = t2 * t;
  w[0] = -0.5f * t3 + t2 - 0.5f * t;
  w[1] = 1.5f * t3 - 2.5f * t2 + 1.0f;
  w[2] = -1.5f * t3 + 2.0f * t2 + 0.5f * t;
  w[3] = 0.5f * t3 - 0.5f * t2;
}

struct Bicubic {
  int64_t row[4];   // clamped tap row * W
  int col[4];       // clamped tap column
  float wx[4], wy[4];
};

__device__ __forceinline__ Bicubic bicubic_setup(float gx, float gy, int H, int W) {
  Bicubic s;
  const float x0f = floorf(gx), y0f = floorf(gy);
  keys_weights(gx - x0f, s.wx);
  keys_weights(gy - y0f, s.wy);
  // A diverged warp produces |g| up to 1e5 and inf (NaN at singular
  // pixels); converting those to int is undefined, so clamp in float first.
  // fmaxf maps NaN to the bound, and NaN still reaches the weights above,
  // so such a sample is NaN as in the plain sampler.
  const int x0 = (int)fminf(fmaxf(x0f, -4.0f), (float)W + 3.0f);
  const int y0 = (int)fminf(fmaxf(y0f, -4.0f), (float)H + 3.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.col[i] = min(max(x0 + i - 1, 0), W - 1);
    s.row[i] = (int64_t)min(max(y0 + i - 1, 0), H - 1) * W;
  }
  return s;
}

// One channel plane [H, W] sampled at the setup's taps, summed in the
// plain sampler's order (rows outer, columns inner).
__device__ __forceinline__ float bicubic_eval(const float* __restrict__ plane,
                                              const Bicubic& s) {
  float out = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out += __ldg(plane + s.row[j] + s.col[i]) * (s.wy[j] * s.wx[i]);
  }
  return out;
}

// This lane's share of one row: wx[k][a] += m[k] * (x/L)^a.
__device__ __forceinline__ void accumulate_pixel(float wx[MAXK][DEG], const float m[MAXK],
                                                 int K, float xn) {
  float xp = 1.0f;
#pragma unroll
  for (int a = 0; a < DEG; ++a) {
    if (a > 0) xp *= xn;
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k < K) wx[k][a] += m[k] * xp;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// End of a row (called by the whole warp): reduce wx over the lanes, then
// lane t = k*DEG + a adds (y/L)^b * rowsum[k][a] into acc[b].
// row_buf holds this warp's MAXK*DEG floats of shared memory.
__device__ __forceinline__ void finish_row(float wx[MAXK][DEG], int K, float yn,
                                           float* row_buf, float acc[DEG], int lane) {
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    if (k < K) {
#pragma unroll
      for (int a = 0; a < DEG; ++a) {
        const float v = warp_sum(wx[k][a]);
        if (lane == 0) row_buf[k * DEG + a] = v;
        wx[k][a] = 0.0f;
      }
    }
  }
  __syncwarp();
  if (lane < K * DEG) {
    const float w = row_buf[lane];
    float yp = 1.0f;
#pragma unroll
    for (int b = 0; b < DEG; ++b) {
      if (b > 0) yp *= yn;
      acc[b] += yp * w;
    }
  }
  __syncwarp();
}

// End of a block (called by every thread): sum the warps' accumulators in
// warp order and write partial[((pair*K + k) * ntiles + tile) * 25 + b*5 + a].
// blk_buf holds WARPS*MAXK*NMOM floats of shared memory.
__device__ __forceinline__ void finish_block(const float acc[DEG], int K, float* blk_buf,
                                             float* __restrict__ partial, int pair,
                                             int ntiles, int tile, int warp, int lane) {
  if (lane < K * DEG) {
    const int k = lane / DEG, a = lane % DEG;
#pragma unroll
    for (int b = 0; b < DEG; ++b)
      blk_buf[warp * MAXK * NMOM + k * NMOM + b * DEG + a] = acc[b];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < K * NMOM) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += blk_buf[w * MAXK * NMOM + t];
    const int k = t / NMOM, e = t % NMOM;
    partial[((int64_t)(pair * K + k) * ntiles + tile) * NMOM + e] = s;
  }
}

// Sum partial [BK, ntiles, 25] over tiles in order into out [BK, 8, 8]
// (rows = y power, cols = x power, zero outside [0:5, 0:5]). Defined in
// weighted_moments.cu.
cudaError_t launch_finalize(const float* partial, float* out, int bk, int ntiles,
                            cudaStream_t stream);

}  // namespace ica
