// K1a: K1's measurement-only ablation variants, for cost attribution
// (eval/attr_bench.py).
//
// Replaces the `ablate=` branches of ops/pallas/fused_iter.py::_iter_common
// (lines 117-166: epionly, noepi, norho, cheapmom) and of
// ops/pallas/tile_warp.py::warp_tile (lines 267-333: nomask, cheapwy,
// nofold; chunk1, chunk2 and rollgather price the TPU's 128-lane tap
// gathers and have no meaning here, where the sampler issues one load a
// tap). Each variant is K1 (fused_iter.cuh) compiled with one cost slice
// removed, a template instance beside the production kernel, never a
// runtime branch inside it:
// * noepi: the warp alone (the samples summed into one moment);
// * epionly: no warp (iw = 0; the coordinates and the domain mask stay);
// * nomask / nofold: no per-tap column / row clamps (the tap origin is
//   clamped once a pixel, so no read leaves the plane);
// * cheapwy: linear y weights in place of the Keys weights;
// * cheapmom: one x factor for every moment power;
// * norho: rho' = t2 * lambda in place of the loss.
// The time a variant saves against the full one prices its slice. The
// variants exist for C = 3 on the robust path, the shape the bench times;
// the full variant (0) is the production kernel's arithmetic under another
// name, and nomask and nofold give its moments bit for bit at delta >= 2.
// Bound on the H100: as K1, memory (fused_iter.cu); these kernels are not
// tuned, they measure.
#include "fused_iter.cuh"

namespace ica {

template <int ABL>
__global__ void __launch_bounds__(K1_THREADS, k1_min_blocks(3))
fused_iter_ablate_kernel(const K1Args a) {
  __shared__ float blk_buf[K1_ROWS * MAXK * NMOM];
  k1_band<3, ABL>(a, blk_buf);
}

template <int ABL>
cudaError_t launch_ablate(const K1Args& a, int grid, cudaStream_t s) {
  fused_iter_ablate_kernel<ABL><<<grid, K1_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace ica

// The arguments of ica_fused_iter_moments, with C = 3 and loss > 0 (out
// [B, 5, 8, 8], partial B * 5 * ceil(Ho / 8) * 25 floats), H, W >= 4, and
// variant, a set of common.cuh's ABL_* knobs: 0 (full), one knob, or
// ABL_NOMASK | ABL_NOFOLD | ABL_CHEAPWY. Any other set, C or loss returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int ica_fused_iter_ablate(const float* i2p, const float* tplp, const float* mat,
                                     const float* lam, float* partial, float* out, int B,
                                     int C, int P, int H, int W, int Ho, int Wo,
                                     int projective, int loss, int nanifoutside, int delta,
                                     int yoff, float inv_l, int variant, void* stream) {
  using namespace ica;
  if (C != 3 || loss <= 0 || H < 4 || W < 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nbands = (Ho + K1_ROWS - 1) / K1_ROWS;
  const int grid = B * nbands;
  const K1Args a{i2p, tplp, mat, lam, partial, C, P, H, W, Ho, Wo, projective, loss,
                 nanifoutside, delta, yoff, inv_l, nbands};
  cudaError_t err;
  switch (variant) {
    case 0: err = launch_ablate<0>(a, grid, s); break;
    case ABL_NOEPI: err = launch_ablate<ABL_NOEPI>(a, grid, s); break;
    case ABL_EPIONLY: err = launch_ablate<ABL_EPIONLY>(a, grid, s); break;
    case ABL_NOMASK: err = launch_ablate<ABL_NOMASK>(a, grid, s); break;
    case ABL_NOFOLD: err = launch_ablate<ABL_NOFOLD>(a, grid, s); break;
    case ABL_CHEAPWY: err = launch_ablate<ABL_CHEAPWY>(a, grid, s); break;
    case ABL_CHEAPMOM: err = launch_ablate<ABL_CHEAPMOM>(a, grid, s); break;
    case ABL_NORHO: err = launch_ablate<ABL_NORHO>(a, grid, s); break;
    case ABL_NOMASK | ABL_NOFOLD | ABL_CHEAPWY:
      err = launch_ablate<ABL_NOMASK | ABL_NOFOLD | ABL_CHEAPWY>(a, grid, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_finalize(partial, out, B * 5, nbands, s);
}
