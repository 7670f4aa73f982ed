// K3: bicubic warp of a planar image batch at per-pixel coordinates.
//
// Replaces ops/pallas/warp.py::pallas_warp_planar (_warp_kernel and its
// streaming twin _warp_kernel_stream). The TPU kernel keeps the plane in
// VMEM, or streams row-band windows into it for large frames; this kernel
// reads the image from device memory, so one kernel serves every frame size.
//
// Bound on the H100: memory. Per output pixel it reads gx, gy (8 bytes) and
// writes C floats, and the image is read once: at 8 x 3 x 388 x 584 that is
// 36 MB of reads (coordinates 14.5 MB, image 21.8 MB) and 21.8 MB of writes,
// 17.3 us at 3.35 TB/s. Design, K1's: one block per (pair, band of 8
// output rows), one warp a row, each lane walking the row's pixels 32 apart
// with coalesced coordinate loads and output stores; 64 registers, so 4
// blocks (32 warps) are resident per SM. The taps come through L1, which
// holds the image rows that neighbouring pixels and rows of the band reuse.
// The tap origin and weights are computed once per pixel and reused for
// every channel (unrolled for RGB). A 2-D tile walker that staged each
// tile's tap box in shared memory by double-buffered cp.async measured
// slower than this on the card (PERF.md §6).
#include "common.cuh"

namespace ica {

constexpr int K3_ROWS = 8;
constexpr int K3_THREADS = 32 * K3_ROWS;
constexpr int K3_MIN_BLOCKS = 4;

// NC channels (unrolled), or C when NC is 0.
template <int NC>
__global__ void __launch_bounds__(K3_THREADS, K3_MIN_BLOCKS)
warp_planar_kernel(const float* __restrict__ img, const float* __restrict__ gx,
                   const float* __restrict__ gy, float* __restrict__ out, int C_, int H, int W,
                   int Ho, int Wo, int nbands) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, C = NC > 0 ? NC : C_;
  const int pair = blockIdx.x / nbands, band = blockIdx.x - pair * nbands;
  const int row = band * K3_ROWS + warp;
  if (row >= Ho) return;
  const int pi = H * W, po = Ho * Wo;   // 32-bit offsets: checked by the wrapper
  const float* src = img + (int64_t)pair * C * pi;
  const float* gxr = gx + ((int64_t)pair * Ho + row) * Wo;
  const float* gyr = gy + ((int64_t)pair * Ho + row) * Wo;
  float* dst = out + (int64_t)pair * C * po + (int64_t)row * Wo;
#pragma unroll 1
  for (int x = lane; x < Wo; x += 32) {
    Sampler s;
    s.setup(__ldg(gxr + x), __ldg(gyr + x), H, W);
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c * po + x] = s.eval(src + c * pi, H, W);
  }
}

}  // namespace ica

// img [B, C, H, W], gx/gy [B, Ho, Wo] -> out [B, C, Ho, Wo], all f32.
extern "C" int ica_warp_planar(const float* img, const float* gx, const float* gy, float* out,
                               int B, int C, int H, int W, int Ho, int Wo, void* stream) {
  using namespace ica;
  const int nbands = (Ho + K3_ROWS - 1) / K3_ROWS;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 3)
    warp_planar_kernel<3><<<B * nbands, K3_THREADS, 0, s>>>(img, gx, gy, out, C, H, W, Ho, Wo,
                                                            nbands);
  else
    warp_planar_kernel<0><<<B * nbands, K3_THREADS, 0, s>>>(img, gx, gy, out, C, H, W, Ho, Wo,
                                                            nbands);
  return (int)cudaGetLastError();
}
