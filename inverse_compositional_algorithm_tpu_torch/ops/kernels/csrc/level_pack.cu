// K7: a pyramid level's set-up, packed in one pass.
//
// Replaces no TPU kernel: XLA fuses this chain in the JAX package
// (models/ic.py's central_gradients -> band -> grad_moments ->
// plan_fused_iter). In the port it was about 20 ATen passes over
// full-frame tensors a level (strided subtracts, pads, band products,
// channel sums, a stack, a cat and two permute copies). Per pixel of pair
// b, from i1 and i2 [B, H, W, C] (NHWC):
//   * ix = 0.5 * (I1[x+1] - I1[x-1]), iy = 0.5 * (I1[y+1] - I1[y-1]), 0 on
//     the one-pixel border (ops/gradients.py::central_gradients), both
//     multiplied by the 0/1 boundary band when `band`
//     (ops/gradients.py::boundary_band_mask at `delta`);
//   * gxx, gxy, gyy = sum over c = 0 .. C-1, in order, of ix*ix, ix*iy, iy*iy;
//   * written straight into K1's planar layout: tplp [B, P, H, W] holds i1,
//     ix, iy (C planes each), then gxx, gxy, gyy when robust (P = 3C + 3;
//     P = 3C quadratic, whose moments go to their own [B, 3, H, W] planes
//     for K4); i2p [B, C, H, W] is i2 in planes.
// Every operation rounds as the ATen chain's: subtract, then the exact
// x0.5, the exact 0/1 band product, and the moments' products and sums
// through the round-to-nearest intrinsics, so nvcc contracts nothing into
// an FMA. Only the order of the channel sum may differ from ATen's
// `.sum(-1)`.
//
// Bound on the H100: bytes. A pixel reads 2C floats and writes 3C + 3 + C
// (robust): 84 B at C = 3, 19.5 GB at the finest level of 1024 584x388
// pairs, 5.8 ms at 3.35 TB/s; the arithmetic is a few flops a value.
// The hard part is the turn from NHWC to planes with both ends coalesced:
// a warp reading one NHWC row touches C planes, and a warp writing one
// plane row wants consecutive x. So a block (8 warps) owns 8 rows x 128
// columns of one pair and goes through shared memory:
// * Staging: the block reads the 10 NHWC rows of i1 it needs (its 8, one
//   halo row above and one below, each with one halo pixel left and right)
//   and its 8 rows of i2, each row segment as consecutive floats (a warp
//   instruction reads 128 contiguous bytes), 8 loads in flight a lane, and
//   scatters them to planar shared memory (one plane per channel, a
//   channel's plane stride skewed across the banks).
// * Compute: warp r writes output row r; lane q its 4 pixels 4q .. 4q + 3.
//   It reads its pixels' channel values as float4 from the staged planes,
//   forms ix, iy, the band and the moments in registers, and stores every
//   plane's 4 values as one float4 (a warp stores 512 contiguous bytes a
//   plane) where W % 4 == 0, else as 4 floats. Nothing intermediate goes to
//   device memory.
// * One block per (pair, band of 8 rows, 128 columns): the finest level of
//   1024 584x388 pairs is 250,880 blocks, many waves of the 132 SMs. At
//   C = 3 a block stages 29 KB. The pair is the grid's z, which holds 65535:
//   a larger batch takes one launch per 65535 pairs, each from its own bases
//   (a 1-D grid that numbers the pairs too made the generic instance spill
//   under the 64-register bound and cost ~5% at C = 3).
// Offsets inside a pair are 32-bit (the wrapper checks P * H * W < 2^31);
// pair bases are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ica {

constexpr int LP_TW = 128;               // output columns of a block: a warp's 32 quads
constexpr int LP_ROWS = 8;               // output rows of a block, one warp each
constexpr int LP_THREADS = LP_ROWS * 32;
constexpr int LP_SROWS = LP_ROWS + 2;    // staged i1 rows: one halo row above and below
constexpr int LP_RS = LP_TW + 8;         // staged i1 row: column x0 - 1 at slot 3, x0 at slot 4
constexpr int LP_BATCH = 8;              // loads a lane keeps in flight while staging

struct LPArgs {
  const float* i1;     // [B, H, W, C]
  const float* i2;     // [B, H, W, C]
  float* tplp;         // [B, P, H, W]
  float* i2p;          // [B, C, H, W]
  float* gm;           // pair 0's gxx plane (in tplp when robust)
  int64_t gm_pair;     // floats from one pair's gxx plane to the next's
  int C, H, W, P;
  int band, delta;     // multiply the gradients by the boundary band of `delta`
  int vec;             // W % 4 == 0: float4 stores
  int ps1, ps2;        // staged plane strides of i1 and i2, floats
};

// One staged line: pixels xbase .. xbase + npx - 1 of an NHWC row (`row`
// points at its pixel 0; rows outside the frame have row_ok false), element
// (px, c) to dst[c * ps + px]; pixels outside the row are staged as 0.
template <int NC>
__device__ __forceinline__ void stage_line(const float* __restrict__ row, bool row_ok, int xbase,
                                           int npx, int W, int Cr, float* __restrict__ dst,
                                           int ps, int lane) {
  const int C = NC > 0 ? NC : Cr;
  const int n = npx * C;
  const int jlo = max(0, -xbase) * C, jhi = min(npx, W - xbase) * C;
  const int dq = 32 / C, dr = 32 - dq * C;
  int px = lane / C, c = lane - (lane / C) * C;
  for (int j0 = lane; j0 < n; j0 += 32 * LP_BATCH) {
    float v[LP_BATCH];
#pragma unroll
    for (int u = 0; u < LP_BATCH; ++u) {
      const int j = j0 + 32 * u;
      v[u] = (row_ok && j >= jlo && j < jhi) ? __ldg(row + (xbase * C + j)) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < LP_BATCH; ++u) {
      if (j0 + 32 * u < n) dst[c * ps + px] = v[u];
      px += dq;
      c += dr;
      if (c >= C) {
        c -= C;
        ++px;
      }
    }
  }
}

__device__ __forceinline__ void store4(float* __restrict__ p, const float v[4], bool vec, int nx) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < nx) p[k] = v[k];
  }
}

template <int NC>
__global__ void __launch_bounds__(LP_THREADS, 4) level_pack_kernel(const LPArgs a) {
  extern __shared__ float4 lp_smem4[];
  float* s1 = reinterpret_cast<float*>(lp_smem4);
  const int C = NC > 0 ? NC : a.C;
  float* s2 = s1 + C * a.ps1;
  const int H = a.H, W = a.W;
  const int pair = blockIdx.z;
  const int x0 = blockIdx.x * LP_TW, y0 = blockIdx.y * LP_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t img = (int64_t)pair * H * W * C;
  const float* i1 = a.i1 + img;
  const float* i2 = a.i2 + img;

  // Staging: lines 0 .. 9 are i1's rows y0 - 1 .. y0 + 8, lines 10 .. 17
  // i2's rows y0 .. y0 + 7.
  for (int line = warp; line < LP_SROWS + LP_ROWS; line += LP_ROWS) {
    if (line < LP_SROWS) {
      const int y = y0 - 1 + line;
      stage_line<NC>(i1 + y * W * C, y >= 0 && y < H, x0 - 1, LP_TW + 2, W, C,
                     s1 + line * LP_RS + 3, a.ps1, lane);
    } else {
      const int y = y0 + line - LP_SROWS;
      stage_line<NC>(i2 + y * W * C, y < H, x0, LP_TW, W, C, s2 + (line - LP_SROWS) * LP_TW,
                     a.ps2, lane);
    }
  }
  __syncthreads();

  const int y = y0 + warp, x = x0 + 4 * lane;
  if (y >= H || x >= W) return;
  const int nx = min(4, W - x);
  const bool yin = y >= 1 && y <= H - 2;
  const bool yband = y >= a.delta && y < H - a.delta;
  const int hw = H * W, off = y * W + x;
  float* tpl = a.tplp + (int64_t)pair * a.P * hw + off;
  float* mov = a.i2p + (int64_t)pair * C * hw + off;
  float* gm = a.gm + pair * a.gm_pair + off;
  float band[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    band[k] = (yband && x + k >= a.delta && x + k < W - a.delta) ? 1.0f : 0.0f;
  float gxx[4] = {0.0f, 0.0f, 0.0f, 0.0f}, gxy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float gyy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float* s = s1 + c * a.ps1 + (warp + 1) * LP_RS + 4 + 4 * lane;
    const float4 cen = *reinterpret_cast<const float4*>(s);
    const float4 up = *reinterpret_cast<const float4*>(s - LP_RS);
    const float4 dn = *reinterpret_cast<const float4*>(s + LP_RS);
    const float4 mv = *reinterpret_cast<const float4*>(s2 + c * a.ps2 + warp * LP_TW + 4 * lane);
    const float row[6] = {s[-1], cen.x, cen.y, cen.z, cen.w, s[4]};
    const float upv[4] = {up.x, up.y, up.z, up.w}, dnv[4] = {dn.x, dn.y, dn.z, dn.w};
    float ix[4], iy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xk = x + k;
      ix[k] = (xk >= 1 && xk <= W - 2) ? __fmul_rn(0.5f, __fsub_rn(row[k + 2], row[k])) : 0.0f;
      iy[k] = yin ? __fmul_rn(0.5f, __fsub_rn(dnv[k], upv[k])) : 0.0f;
      if (a.band) {
        ix[k] = __fmul_rn(ix[k], band[k]);
        iy[k] = __fmul_rn(iy[k], band[k]);
      }
      gxx[k] = __fadd_rn(gxx[k], __fmul_rn(ix[k], ix[k]));
      gxy[k] = __fadd_rn(gxy[k], __fmul_rn(ix[k], iy[k]));
      gyy[k] = __fadd_rn(gyy[k], __fmul_rn(iy[k], iy[k]));
    }
    const float iv[4] = {cen.x, cen.y, cen.z, cen.w}, mvv[4] = {mv.x, mv.y, mv.z, mv.w};
    store4(tpl + c * hw, iv, a.vec, nx);
    store4(tpl + (C + c) * hw, ix, a.vec, nx);
    store4(tpl + (2 * C + c) * hw, iy, a.vec, nx);
    store4(mov + c * hw, mvv, a.vec, nx);
  }
  store4(gm, gxx, a.vec, nx);
  store4(gm + hw, gxy, a.vec, nx);
  store4(gm + 2 * hw, gyy, a.vec, nx);
}

// Floats of a staged plane: `rows` x `cols`, padded so that a channel's
// plane starts ceil(32 / C) banks (rounded up to a float4) after the one
// before, which spreads a staging warp's 32 scattered stores over the banks.
inline int lp_plane_stride(int rows, int cols, int C) {
  const int skew = (((32 + C - 1) / C + 3) / 4 * 4) % 32;
  const int base = rows * cols;
  return base + ((skew - base % 32) % 32 + 32) % 32;
}

inline size_t lp_smem_bytes(int C) {
  return (size_t)C *
         (lp_plane_stride(LP_SROWS, LP_RS, C) + lp_plane_stride(LP_ROWS, LP_TW, C)) *
         sizeof(float);
}

template <int NC>
cudaError_t launch_level_pack(const LPArgs& a, dim3 grid, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        level_pack_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  level_pack_kernel<NC><<<grid, LP_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace ica

// i1, i2 [B, H, W, C] f32 -> tplp [B, P, H, W] (P = 3C + 3 when robust,
// else 3C), i2p [B, C, H, W] and, on the quadratic path, gmom [B, 3, H, W]
// (ignored when robust: the moments are tplp's last 3 planes). band: apply
// the boundary band of `delta` to the gradients. A C whose staged block
// exceeds the SM's shared memory (C > 23) returns the refusal's error.
// Batches past the grid's 65535 pairs launch once per 65535.
extern "C" int ica_level_pack(const float* i1, const float* i2, float* tplp, float* i2p,
                              float* gmom, int B, int C, int H, int W, int robust, int band,
                              int delta, void* stream) {
  using namespace ica;
  const int P = robust ? 3 * C + 3 : 3 * C;
  const int64_t hw = (int64_t)H * W;
  LPArgs a{i1, i2, tplp, i2p, robust ? tplp + 3 * C * hw : gmom, (robust ? P : 3) * hw,
           C, H, W, P, band, delta, W % 4 == 0,
           lp_plane_stride(LP_SROWS, LP_RS, C), lp_plane_stride(LP_ROWS, LP_TW, C)};
  const size_t smem = lp_smem_bytes(C);
  cudaStream_t s = (cudaStream_t)stream;
  for (int b0 = 0; b0 < B; b0 += 65535) {
    const int nb = B - b0 < 65535 ? B - b0 : 65535;
    LPArgs c = a;
    c.i1 += (int64_t)b0 * hw * C;
    c.i2 += (int64_t)b0 * hw * C;
    c.tplp += (int64_t)b0 * P * hw;
    c.i2p += (int64_t)b0 * C * hw;
    c.gm += b0 * a.gm_pair;
    const dim3 grid((W + LP_TW - 1) / LP_TW, (H + LP_ROWS - 1) / LP_ROWS, nb);
    const cudaError_t e = C == 3   ? launch_level_pack<3>(c, grid, smem, s)
                          : C == 1 ? launch_level_pack<1>(c, grid, smem, s)
                                   : launch_level_pack<0>(c, grid, smem, s);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
