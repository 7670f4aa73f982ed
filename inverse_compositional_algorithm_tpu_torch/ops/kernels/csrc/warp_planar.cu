// K3: bicubic warp of a planar image batch at per-pixel coordinates.
//
// Replaces ops/pallas/warp.py::pallas_warp_planar (_warp_kernel and its
// streaming twin _warp_kernel_stream). The TPU kernel keeps the plane in
// VMEM, or streams row-band windows into it for large frames; this kernel
// reads the image from device memory through the read-only cache, so one
// kernel serves every frame size.
//
// Bound on the H100: memory. Per output pixel it reads gx, gy (8 bytes),
// writes C floats and gathers 16*C taps, which for a smooth warp mostly hit
// L1/L2 (rows of neighbouring threads overlap). At 8 x 3 x 388 x 584 that
// is about 36 MB of compulsory reads (coordinates 14.5 MB, image 21.8 MB)
// and 21.8 MB of writes. Design: one thread
// per output pixel (coalesced coordinate loads and output stores), the tap
// indices and weights computed once and reused for every channel.
#include "common.cuh"

namespace ica {

__global__ void __launch_bounds__(256)
warp_planar_kernel(const float* __restrict__ img, const float* __restrict__ gx,
                   const float* __restrict__ gy, float* __restrict__ out, int C, int H,
                   int W, int64_t n_out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= n_out) return;
  const int64_t g = (int64_t)b * n_out + p;
  const Bicubic s = bicubic_setup(gx[g], gy[g], H, W);
  const int64_t plane = (int64_t)H * W;
  const float* src = img + (int64_t)b * C * plane;
  float* dst = out + (int64_t)b * C * n_out + p;
  for (int c = 0; c < C; ++c) dst[c * n_out] = bicubic_eval(src + c * plane, s);
}

}  // namespace ica

// img [B, C, H, W], gx/gy [B, Ho, Wo] -> out [B, C, Ho, Wo], all f32.
extern "C" int ica_warp_planar(const float* img, const float* gx, const float* gy, float* out,
                               int B, int C, int H, int W, int Ho, int Wo, void* stream) {
  const int64_t n_out = (int64_t)Ho * Wo;
  const dim3 grid((unsigned)((n_out + 255) / 256), B);
  ica::warp_planar_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(img, gx, gy, out, C, H, W,
                                                                  n_out);
  return (int)cudaGetLastError();
}
