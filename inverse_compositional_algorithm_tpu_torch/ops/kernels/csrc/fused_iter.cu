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
#include "fused_iter.cuh"

namespace ica {

// One block per (pair, band): k1_band (fused_iter.cuh).
template <int NC>
__global__ void __launch_bounds__(K1_THREADS, k1_min_blocks(NC))
fused_iter_kernel(const K1Args a) {
  __shared__ float blk_buf[K1_ROWS * MAXK * NMOM];
  k1_band<NC>(a, blk_buf);
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
