// K1: one inverse-compositional Gauss-Newton iteration in one pass.
//
// Replaces ops/pallas/fused_iter.py::fused_iter_moments (_iter_kernel ->
// _iter_common, and the streaming twin _iter_kernel_stream). Per pixel:
// bicubic warp of I2 at (gx, gy) (common.cuh), DI masked by the delta domain
// (both nanifoutside forms), t2 = sum_c DI^2 and rho'(t2; lambda of the
// pair), u = sum_c Ix*DI and v = sum_c Iy*DI, then the maps
// (rho*gxx, rho*gxy, rho*gyy, rho*u, rho*v), or (u, v) on the quadratic
// path, contracted into [K, 5, 5] coordinate moments with global rows
// (row + y_offset). No per-pixel intermediate goes to device memory.
//
// Bound on the H100: memory. A pair reads i2 (C planes, gathered), the
// packed template (3C or 3C+3 planes) and gx, gy: 17 f32 planes for RGB on
// the robust path, 17 * 388 * 584 * 4 B = 15.4 MB per pair per iteration at
// the flagship's finest level, against 3.35 TB/s. The arithmetic (48 taps,
// the epilogue and 25 moment FMAs per pixel) is well under the FP32 rate.
// Design: one block per (pair, tile of WARPS rows), one warp per row walking
// it with coalesced loads of gx, gy and the template; the moment reduction
// is the two-pass deterministic one of common.cuh.
#include "common.cuh"

namespace ica {

// rho'(t2; lambda) for RobustLoss values 1..4 (ops/normal_equations.py::rhop).
__device__ __forceinline__ float rhop(float t2, float lam2, int loss) {
  switch (loss) {
    case 1:  // TRUNCATED_QUADRATIC
      return t2 < lam2 ? 1.0f : 0.0f;
    case 2: {  // GERMAN_MCCLURE
      const float s = lam2 + t2;
      return lam2 / (s * s);
    }
    case 3:  // LORENTZIAN
      return 1.0f / (lam2 + t2);
    default:  // CHARBONNIER
      return rsqrtf(t2 + lam2);
  }
}

__global__ void __launch_bounds__(THREADS)
fused_iter_kernel(const float* __restrict__ i2p, const float* __restrict__ tplp,
                  const float* __restrict__ gxp, const float* __restrict__ gyp,
                  const float* __restrict__ lam, float* __restrict__ partial, int C, int P,
                  int H, int W, int Ho, int Wo, int loss, int nanifoutside, int delta,
                  int yoff, float inv_l, int ntiles) {
  __shared__ float row_buf[WARPS][MAXK * DEG];
  __shared__ float blk_buf[WARPS * MAXK * NMOM];
  const int pair = blockIdx.y, tile = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = tile * WARPS + warp;
  const int K = loss > 0 ? 5 : 2;
  float acc[DEG] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (row < Ho) {
    float wx[MAXK][DEG] = {};
    const int64_t plane_in = (int64_t)H * W, plane_out = (int64_t)Ho * Wo;
    const float* img = i2p + (int64_t)pair * C * plane_in;
    const float* tpl = tplp + (int64_t)pair * P * plane_out + (int64_t)row * Wo;
    const float* gxr = gxp + ((int64_t)pair * Ho + row) * Wo;
    const float* gyr = gyp + ((int64_t)pair * Ho + row) * Wo;
    const float lam_b = lam[pair];
    const float lam2 = lam_b * lam_b;
    const float d = (float)delta;
    const float xhi = (float)(W - 1) - d, yhi = (float)(H - 1) - d;
    for (int x = lane; x < Wo; x += 32) {
      const float gx = gxr[x], gy = gyr[x];
      const float valid = (gx >= d && gx <= xhi && gy >= d && gy <= yhi) ? 1.0f : 0.0f;
      const Bicubic s = bicubic_setup(gx, gy, H, W);
      float u = 0.0f, v = 0.0f, t2 = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float iw = bicubic_eval(img + c * plane_in, s);
        const float i1 = tpl[c * plane_out + x];
        // Multiplying by valid (not selecting) keeps a NaN sample NaN, as
        // the TPU kernel and the plain masked residual do.
        const float di = nanifoutside ? (iw - i1) * valid : iw * valid - i1;
        u += tpl[(int64_t)(C + c) * plane_out + x] * di;
        v += tpl[(int64_t)(2 * C + c) * plane_out + x] * di;
        t2 += di * di;
      }
      float m[MAXK];
      if (loss > 0) {
        const float rho = rhop(t2, lam2, loss);
        m[0] = rho * tpl[(int64_t)(3 * C) * plane_out + x];
        m[1] = rho * tpl[(int64_t)(3 * C + 1) * plane_out + x];
        m[2] = rho * tpl[(int64_t)(3 * C + 2) * plane_out + x];
        m[3] = rho * u;
        m[4] = rho * v;
      } else {
        m[0] = u;
        m[1] = v;
        m[2] = m[3] = m[4] = 0.0f;
      }
      accumulate_pixel(wx, m, K, (float)x * inv_l);
    }
    finish_row(wx, K, (float)(row + yoff) * inv_l, row_buf[warp], acc, lane);
  }
  finish_block(acc, K, blk_buf, partial, pair, ntiles, tile, warp, lane);
}

}  // namespace ica

// i2p [B, C, H, W]; tplp [B, P, Ho, Wo] packed (i1, ix, iy: C planes each,
// then gxx, gxy, gyy when loss > 0); gx, gy [B, Ho, Wo]; lam [B]; loss is
// the RobustLoss value, 0 for the quadratic path. out [B, K, 8, 8] with
// K = 5 (loss > 0) or 2; partial is scratch of B * K * ceil(Ho / 8) * 25.
extern "C" int ica_fused_iter_moments(const float* i2p, const float* tplp, const float* gx,
                                      const float* gy, const float* lam, float* partial,
                                      float* out, int B, int C, int P, int H, int W, int Ho,
                                      int Wo, int loss, int nanifoutside, int delta, int yoff,
                                      float inv_l, void* stream) {
  using namespace ica;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (Ho + WARPS - 1) / WARPS;
  fused_iter_kernel<<<dim3(ntiles, B), THREADS, 0, s>>>(
      i2p, tplp, gx, gy, lam, partial, C, P, H, W, Ho, Wo, loss, nanifoutside, delta, yoff,
      inv_l, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_finalize(partial, out, B * (loss > 0 ? 5 : 2), ntiles, s);
}
