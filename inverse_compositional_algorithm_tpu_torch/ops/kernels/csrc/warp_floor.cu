// K5: the warp's floor, a bicubic warp with static indices and weights.
//
// Replaces the stripped Pallas kernel of eval/benchmarks.py::vpu_floor
// (the pallas_call at benchmarks.py:331), which gives the fused iteration's
// warp data movement and interpolation arithmetic without its coordinate
// math, predicates or tap clipping, so that the benchmark can price the
// real warp logic (fused_over_floor). Here it is K3's warp with everything
// data-dependent removed: out[b,c,y,x] = sum_{i,j<4} wy_i wx_j
// img[b,c,y+i,x+j] for x < W-3, y < H-3, with Keys weights at the static
// fractions fx = (x mod 32)/32 and fy = (y mod 8)/8. No coordinates are
// read, and every tap is in range by construction, so nothing is clamped.
//
// Bound on the H100: memory. It reads the image once and writes the output
// once: at 8 x 3 x 388 x 584 that is 21.75 MB read and 21.47 MB written,
// about 12.9 us at 3.35 TB/s; the arithmetic (54 flops per pixel for the
// weights and their products, 32 per channel for the taps) is about 4 us at
// the 67 TFLOP/s FP32 rate. Design:
// one thread per output pixel, as warp_planar.cu (coalesced stores, the 16
// taps through the read-only cache, shared by neighbouring threads in L1),
// the weights formed once per thread and reused for every channel.
#include "common.cuh"

namespace ica {

__global__ void __launch_bounds__(256)
warp_floor_kernel(const float* __restrict__ img, float* __restrict__ out, int C, int H, int W,
                  int Wo, int64_t n_out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= n_out) return;
  const int y = (int)(p / Wo), x = (int)(p % Wo);
  Bicubic s;
  keys_weights((float)(x & 31) * (1.0f / 32.0f), s.wx);
  keys_weights((float)(y & 7) * 0.125f, s.wy);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.col[i] = x + i;
    s.row[i] = (int64_t)(y + i) * W;
  }
  const int64_t plane = (int64_t)H * W;
  const float* src = img + (int64_t)b * C * plane;
  float* dst = out + (int64_t)b * C * n_out + p;
  for (int c = 0; c < C; ++c) dst[c * n_out] = bicubic_eval(src + c * plane, s);
}

}  // namespace ica

// img [B, C, H, W] -> out [B, C, H - 3, W - 3], f32 (H, W >= 4).
extern "C" int ica_warp_floor(const float* img, float* out, int B, int C, int H, int W,
                              void* stream) {
  const int Wo = W - 3;
  const int64_t n_out = (int64_t)(H - 3) * Wo;
  const dim3 grid((unsigned)((n_out + 255) / 256), B);
  ica::warp_floor_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(img, out, C, H, W, Wo, n_out);
  return (int)cudaGetLastError();
}
