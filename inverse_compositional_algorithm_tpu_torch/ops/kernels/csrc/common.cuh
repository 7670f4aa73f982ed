// Device code shared by the alignment kernels (fused_iter.cu, warp_planar.cu,
// weighted_moments.cu), K1's ablation variants (fused_iter_ablate.cu) and
// the benchmark's warp floor (warp_floor.cu).
//
// * The Keys (a = -0.5) bicubic sampler with Neumann (clip-to-edge) taps,
//   the semantics of ops/warp.py::bicubic_sample: keys_weights (K1, K3, K5),
//   tap_origin and Sampler (K1, K3; BasicSampler<ABL> also takes the
//   measurement-only knobs of K1's ablation variants). Replaces the TPU's
//   shared tile core ops/pallas/tile_warp.py::warp_tile. The TPU core
//   reads a tile's taps out of a VMEM window (fast tier) or from HBM
//   (general tier); here every tap is read from device memory through L1,
//   exact for any coordinate.
//   A shared-memory tier (each tile's tap box staged by cp.async) was built
//   for K1 and K3 and measured slower than this on both (PERF.md §6).
// * accumulate_pixel / finish_row / finish_tile_row / finish_block /
//   launch_finalize: the coordinate-moment epilogue
//   M_k[b][a] = sum_p w_k(p) (x/L)^a (y/L)^b, a, b < 5, shared by the fused iteration (K1) and the moment kernel (K4).
//   The TPU kernels carry the sum across sequential grid steps; CUDA blocks
//   run in parallel in no order, so every block writes a partial [K][5][5]
//   and a second kernel adds the partials in a fixed order: no atomics, and
//   runs repeat bit for bit.
// * mbar_init / mbar_wait / tma_load_3d: an mbarrier in shared memory and a
//   TMA copy of a 3-D box of a tensor map into shared memory that completes
//   on it (K5).
#pragma once

#include <cuda.h>
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

// One halving step of finish_tile_row: lanes with bit O set keep the upper
// half of v[0 .. 2O), the others the lower half, each adding its partner's.
template <int O>
__device__ __forceinline__ void halve(float (&v)[32], bool upper) {
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// End of a row of a band kernel (K1; called by the whole warp): the same sums
// as finish_row, without shared memory and with 31 shuffles instead of 125.
// The 25 (k, a) sums, zero-padded to 32, are halved across the lanes five
// times (recursive halving), so lane t = k*DEG + a ends with rowsum[k][a]
// and adds (y/L)^b times it into acc[b].
__device__ __forceinline__ void finish_tile_row(const float wx[MAXK][DEG], int K, float yn,
                                                float acc[DEG], int lane) {
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = i < MAXK * DEG ? wx[i / DEG][i % DEG] : 0.0f;
  halve<16>(v, lane & 16);
  halve<8>(v, lane & 8);
  halve<4>(v, lane & 4);
  halve<2>(v, lane & 2);
  halve<1>(v, lane & 1);
  if (lane < K * DEG) {
    float yp = 1.0f;
#pragma unroll
    for (int b = 0; b < DEG; ++b) {
      if (b > 0) yp *= yn;
      acc[b] += yp * v[0];
    }
  }
}

// End of a block (called by every thread): sum the NW warps' accumulators in
// warp order and write partial[((pair*K + k) * ntiles + tile) * 25 + b*5 + a].
// blk_buf holds NW*MAXK*NMOM floats of shared memory.
template <int NW = WARPS>
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
    for (int w = 0; w < NW; ++w) s += blk_buf[w * MAXK * NMOM + t];
    const int k = t / NMOM, e = t % NMOM;
    partial[((int64_t)(pair * K + k) * ntiles + tile) * NMOM + e] = s;
  }
}

// ---- The sampler of K1 and K3 ----

// The integer tap origin floor(g), clamped to [-4, n + 3] in float: a
// diverged warp produces |g| up to 1e5 and inf (NaN at singular pixels),
// and converting those to int is undefined. fmaxf maps NaN to -4; its
// weights are NaN, so its sample is NaN whatever taps it reads, as in the
// plain sampler. The taps are origin - 1 .. origin + 2, each clamped to the
// image.
__device__ __forceinline__ int tap_origin(float g, int n) {
  return (int)fminf(fmaxf(floorf(g), -4.0f), (float)n + 3.0f);
}

// Measurement-only knobs of K1's ablation variants (fused_iter_ablate.cu,
// eval/attr_bench.py): each removes one cost slice, and the moments are
// then wrong by design. Production code instantiates none of them.
constexpr int ABL_NOMASK = 1;     // no per-tap column clamps (the origin clamped once)
constexpr int ABL_NOFOLD = 2;     // no per-tap row clamps (the origin clamped once)
constexpr int ABL_CHEAPWY = 4;    // linear y weights in place of the Keys weights
constexpr int ABL_NOEPI = 8;      // K1: the warp alone, samples summed into one moment
constexpr int ABL_EPIONLY = 16;   // K1: no warp (iw = 0); template, rho', moments stay
constexpr int ABL_CHEAPMOM = 32;  // K1: one x factor for every moment power
constexpr int ABL_NORHO = 64;     // K1: rho' = t2 * lambda in place of the loss

// The identity, hidden from the compiler's arithmetic. A variant that drops
// a clamp passes the index through it, so that the tap addresses are built
// as for a clamped index and the variant differs from production by the
// clamp alone (folded into the addresses, the unclamped rows spilled
// registers at K1's 80-register cap).
__device__ __forceinline__ int opaque(int v) {
  int r;
  asm("mov.b32 %0, %1;" : "=r"(r) : "r"(v));
  return r;
}

// One point's tap origin and Keys weights; eval(plane, H, W) samples a
// plane [H, W] at its 16 clamped taps, read from device memory through L1,
// as rows of column sums sum_j wy[j] * (sum_i wx[i] * tap[j][i]). setup
// once per point, eval once per channel. ABL (0 in production: `Sampler`)
// takes the ABL_NOMASK, ABL_NOFOLD and ABL_CHEAPWY knobs. Without the
// per-tap clamps of an axis, setup clamps that axis's origin to
// [1, n - 3] once, so every tap still lies in the plane (n >= 4); a point
// inside the delta domain (delta >= 2) has all its taps there already, so
// its sample is unchanged.
template <int ABL = 0>
struct BasicSampler {
  int x0, y0;   // the tap origin (tap_origin)
  float wx[4], wy[4];

  __device__ __forceinline__ void setup(float gx, float gy, int H, int W) {
    const float x0f = floorf(gx), y0f = floorf(gy);
    keys_weights(gx - x0f, wx);
    if constexpr ((ABL & ABL_CHEAPWY) != 0) {
      const float t = gy - y0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) wy[j] = (t + 1.0f - (float)j) * 0.01f;
    } else {
      keys_weights(gy - y0f, wy);
    }
    x0 = tap_origin(gx, W);
    y0 = tap_origin(gy, H);
    if constexpr ((ABL & ABL_NOMASK) != 0) x0 = min(max(x0, 1), W - 3);
    if constexpr ((ABL & ABL_NOFOLD) != 0) y0 = min(max(y0, 1), H - 3);
  }

  __device__ __forceinline__ float eval(const float* __restrict__ plane, int H, int W) const {
    float out = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int yr = y0 + j - 1;
      if constexpr ((ABL & ABL_NOFOLD) == 0)
        yr = min(max(yr, 0), H - 1);
      else
        yr = opaque(yr);
      const float* r = plane + yr * W;
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int xc = x0 + i - 1;
        if constexpr ((ABL & ABL_NOMASK) == 0)
          xc = min(max(xc, 0), W - 1);
        else
          xc = opaque(xc);
        s += wx[i] * __ldg(r + xc);
      }
      out += wy[j] * s;
    }
    return out;
  }
};
using Sampler = BasicSampler<>;

// ---- TMA and mbarriers (K5) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread: make the barrier wait for one arrival per phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One thread: copy the box of `map` at (x, y, z) into dst (128-B aligned
// shared memory) and arrive on `bar`, which completes when the box's
// `bytes` have landed. TMA zero-fills the part of the box outside the tensor.
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map, uint64_t* bar,
                                            uint32_t bytes, int x, int y, int z) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// Sum partial [BK, ntiles, 25] over tiles in order into out [BK, 8, 8]
// (rows = y power, cols = x power, zero outside [0:5, 0:5]). Defined in
// weighted_moments.cu.
cudaError_t launch_finalize(const float* partial, float* out, int bk, int ntiles,
                            cudaStream_t stream);

}  // namespace ica
