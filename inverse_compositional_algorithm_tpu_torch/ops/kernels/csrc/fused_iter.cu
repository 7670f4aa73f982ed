// K1: one inverse-compositional Gauss-Newton iteration in one pass.
//
// Replaces ops/pallas/fused_iter.py::fused_iter_moments (_iter_kernel ->
// _iter_common, and the streaming twin _iter_kernel_stream), composed with
// ops/transforms.py::transform_grid. Per pixel: the sampling point under the
// pair's 3x3 motion, bicubic warp of I2 there (common.cuh's sampler), DI
// masked by the delta domain (both nanifoutside forms), t2 = sum_c DI^2 and
// rho'(t2; lambda of the pair), u = sum_c Ix*DI and v = sum_c Iy*DI, then
// the maps (rho*gxx, rho*gxy, rho*gyy, rho*u, rho*v), or (u, v) on the
// quadratic path, contracted into [K, 5, 5] coordinate moments with global
// rows (row + y_offset). No per-pixel intermediate goes to device memory.
//
// Bound on the H100: memory. A pair reads i2 (C planes) and the packed
// template (3C + 3 planes robust, 3C quadratic) once, plus lambda and the
// matrix: 15 f32 planes for RGB on the robust path, 13.6 MB per pair per
// iteration at the flagship's finest level (388 x 584), 108.8 MB and
// 32.5 us at batch 8 against 3.35 TB/s. The arithmetic (about 240 flops a
// pixel) is far below the FP32 rate. The kernel is paced by the latency of
// its loads, so the design keeps loads off each pixel's dependent chain and
// many of them in flight:
// * The coordinates are formed here from the matrix, in transform_grid's
//   order with round-to-nearest intrinsics (no FMA contraction: one ulp can
//   flip a pixel's domain mask). Loading them was the head of every pixel's
//   chain; now they cost no planes, no loads and no launches.
// * The channel loop is unrolled for 1 and 3 channels, so a pixel's 48 tap
//   loads and its template loads issue together.
// * The template is read once, with streaming loads (evict first), so L1
//   keeps the image rows that neighbouring pixels' and rows' taps reuse.
// * One block per (pair, band of 8 rows), one warp a row: at batch 8 the
//   flagship's 392 blocks fit the 396 resident slots (3 blocks of 8 warps
//   per SM at the 80-register cap), one wave; each row's moment sums are
//   reduced once, at its end (finish_tile_row). A 64-register cap (32
//   warps) spills and measured slower, and at batch 8 there are only 23.8
//   rows per SM to give warps.
// * Taps come from device memory through L1 (common.cuh's Sampler). A
//   shared-memory tier (each tile's box of I2 staged by cp.async,
//   double-buffered) was built and measured slower on this kernel: the L1
//   already holds the rows, and the staging cost registers and a barrier a
//   tile (PERF.md §6).
// * Moments stay deterministic: each block writes its band's [K, 5, 5]
//   partial and launch_finalize sums them in band order; no atomics.
// Tensor cores stay out: TF32 keeps about 3 digits where the TPU kernel
// contracts at Precision.HIGHEST, and the 25 moment FMAs a pixel are far
// below the byte bound anyway.
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

// Sampling point of pixel (x, y) under the row-major 3x3 motion m, rounded
// as transform_grid rounds it: ((m0 * x) + (m1 * y)) + m2 for each row, and
// the homography's division by the third row.
__device__ __forceinline__ void motion_point(const float* __restrict__ m, int projective,
                                              float x, float y, float& gx, float& gy) {
  gx = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m), x), __fmul_rn(__ldg(m + 1), y)), __ldg(m + 2));
  gy = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m + 3), x), __fmul_rn(__ldg(m + 4), y)),
                 __ldg(m + 5));
  if (projective) {
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m + 6), x), __fmul_rn(__ldg(m + 7), y)),
                              __ldg(m + 8));
    gx = __fdiv_rn(gx, d);
    gy = __fdiv_rn(gy, d);
  }
}

// K1's geometry: a block owns a band of K1_ROWS output rows of a pair, one
// warp a row. For 1 or 3 channels (unrolled) 3 resident blocks per SM cap
// the registers at 80 a thread (65536 / (256 * 3) = 85, allocated in
// steps of 8); any other C loops over its channels at 2 blocks (128).
constexpr int K1_ROWS = 8;
constexpr int K1_THREADS = 32 * K1_ROWS;
constexpr int k1_min_blocks(int nc) { return nc > 0 ? 3 : 2; }

struct K1Args {
  const float* __restrict__ i2p;
  const float* __restrict__ tplp;
  const float* __restrict__ mat;
  const float* __restrict__ lam;
  float* __restrict__ partial;
  int C, P, H, W, Ho, Wo, projective, loss, nanifoutside, delta, yoff;
  float inv_l;
  int nbands;
};

// One row of a band: the lane's pixels x = lane, lane + 32, ..., each
// sampled from device memory, added into wx.
template <int NC>
__device__ __forceinline__ void k1_row(const K1Args& a, int pair, int row,
                                       float wx[MAXK][DEG], int lane) {
  const int C = NC > 0 ? NC : a.C;
  const int K = a.loss > 0 ? 5 : 2;
  const int plane = a.Ho * a.Wo;   // 32-bit offsets: checked by the wrapper
  const float* tpl = a.tplp + (int64_t)pair * a.P * plane + (int64_t)row * a.Wo;
  const int pi = a.H * a.W;
  const float* src = a.i2p + (int64_t)pair * C * pi;
  const float* m = a.mat + pair * 9;
  const float lam_b = __ldg(a.lam + pair);
  const float lam2 = lam_b * lam_b;
  const float d = (float)a.delta;
  const float xhi = (float)(a.W - 1) - d, yhi = (float)(a.H - 1) - d;
  const float yf = (float)(row + a.yoff);
#pragma unroll 1
  for (int x = lane; x < a.Wo; x += 32) {
    float gx, gy;
    motion_point(m, a.projective, (float)x, yf, gx, gy);
    const float valid = (gx >= d && gx <= xhi && gy >= d && gy <= yhi) ? 1.0f : 0.0f;
    Sampler s;
    s.setup(gx, gy, a.H, a.W);
    // The template is read once: streaming loads (evict first) leave L1
    // to the taps.
    const float* t = tpl + x;
    float u = 0.0f, v = 0.0f, t2 = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float iw = s.eval(src + c * pi, a.H, a.W);
      const float i1 = __ldcs(t + c * plane);
      // Multiplying by valid (not selecting) keeps a NaN sample NaN, as
      // the TPU kernel and the plain masked residual do.
      const float di = a.nanifoutside ? (iw - i1) * valid : iw * valid - i1;
      u += __ldcs(t + (C + c) * plane) * di;
      v += __ldcs(t + (2 * C + c) * plane) * di;
      t2 += di * di;
    }
    float mk[MAXK];
    if (a.loss > 0) {
      const float rho = rhop(t2, lam2, a.loss);
      mk[0] = rho * __ldcs(t + 3 * C * plane);
      mk[1] = rho * __ldcs(t + (3 * C + 1) * plane);
      mk[2] = rho * __ldcs(t + (3 * C + 2) * plane);
      mk[3] = rho * u;
      mk[4] = rho * v;
    } else {
      mk[0] = u;
      mk[1] = v;
      mk[2] = mk[3] = mk[4] = 0.0f;
    }
    accumulate_pixel(wx, mk, K, (float)x * a.inv_l);
  }
}

// One block per (pair, band), pair-major: each warp sums its row's moments,
// reduced once at the row's end, and the block writes the band's [K, 5, 5]
// partial.
template <int NC>
__global__ void __launch_bounds__(K1_THREADS, k1_min_blocks(NC))
fused_iter_kernel(const K1Args a) {
  __shared__ float blk_buf[K1_ROWS * MAXK * NMOM];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int K = a.loss > 0 ? 5 : 2;
  const int pair = blockIdx.x / a.nbands, band = blockIdx.x - pair * a.nbands;
  const int row = band * K1_ROWS + warp;
  float acc[DEG] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (row < a.Ho) {
    float wx[MAXK][DEG] = {};
    k1_row<NC>(a, pair, row, wx, lane);
    finish_tile_row(wx, K, (float)(row + a.yoff) * a.inv_l, acc, lane);
  }
  finish_block<K1_ROWS>(acc, K, blk_buf, a.partial, pair, a.nbands, band, warp, lane);
}

}  // namespace ica

// i2p [B, C, H, W]; tplp [B, P, Ho, Wo] packed (i1, ix, iy: C planes each,
// then gxx, gxy, gyy when loss > 0); mat [B, 3, 3] row-major motion (the
// third row is used when projective); lam [B]; loss is the RobustLoss value,
// 0 for the quadratic path. out [B, K, 8, 8] with K = 5 (loss > 0) or 2;
// partial is scratch of B * K * ceil(Ho / 8) * 25 floats (a partial per band).
extern "C" int ica_fused_iter_moments(const float* i2p, const float* tplp, const float* mat,
                                      const float* lam, float* partial, float* out, int B,
                                      int C, int P, int H, int W, int Ho, int Wo,
                                      int projective, int loss, int nanifoutside, int delta,
                                      int yoff, float inv_l, void* stream) {
  using namespace ica;
  cudaStream_t s = (cudaStream_t)stream;
  const int nbands = (Ho + K1_ROWS - 1) / K1_ROWS;
  const K1Args a{i2p, tplp, mat, lam, partial, C, P, H, W, Ho, Wo, projective, loss,
                 nanifoutside, delta, yoff, inv_l, nbands};
  if (C == 3)
    fused_iter_kernel<3><<<B * nbands, K1_THREADS, 0, s>>>(a);
  else if (C == 1)
    fused_iter_kernel<1><<<B * nbands, K1_THREADS, 0, s>>>(a);
  else
    fused_iter_kernel<0><<<B * nbands, K1_THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_finalize(partial, out, B * (loss > 0 ? 5 : 2), nbands, s);
}
