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
// about 12.9 us at 3.35 TB/s; the arithmetic is about 4 us at the
// 67 TFLOP/s FP32 rate. Design: one block of 4 warps per output tile of
// K5_TH rows x K5_TW columns of one plane (a (pair, channel)), a column a
// thread. Every tile's input box (the tile plus 3 rows and 3 columns) is
// known before the launch, so it is staged in shared memory whole: by TMA
// from a tensor map over [B*C, H, W] on a persistent grid, each block
// walking tiles through a K5_STAGES ring so the next box lands while this
// one is summed (W % 4 == 0 and a 16-B aligned base, which TMA needs), or
// else by coalesced plain loads, a tile a block. 16-row tiles and a
// 2-stage ring measured fastest with a cold L2 against 8, 32 and 64 rows,
// 1 and 3 stages, and a grid of one tile a block (PERF.md §6). The taps
// are separable: a thread sums each box row horizontally once (4 FMAs) and
// slides a window of 4 row sums down its column (4 FMAs an output). The
// tile's origin is a multiple of 32 columns and 8 rows, so wx depends on
// the lane alone and wy on the row mod 8: the weights are formed once per
// thread. Stores are 32-bit and coalesced, a warp over 32 columns; rows of
// W-3 floats are not 16-B multiples, so neither TMA stores nor vector
// stores apply, and the edge past the frame is masked. The sums are K3's
// Sampler's, row sums first.
#include <atomic>

#include "common.cuh"

namespace ica {

constexpr int K5_TW = 128;                      // output tile width: a column a thread
constexpr int K5_TH = 16;                       // output tile height, a multiple of 8
constexpr int K5_THREADS = K5_TW;
constexpr int K5_BH = K5_TH + 3;                // box rows
constexpr int K5_BW = K5_TW + 4;                // box row pitch in floats (TMA rows: 16-B multiples)
constexpr int K5_STAGE = (K5_BH * K5_BW + 31) / 32 * 32;   // floats a box takes, 128-B aligned
constexpr int K5_STAGES = 2;                    // TMA ring depth

template <bool TMA>
__global__ void __launch_bounds__(K5_THREADS)
warp_floor_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ img,
                  float* __restrict__ out, int H, int W, int Ho, int Wo, int tiles_x,
                  int tiles_plane, int ntiles) {
  extern __shared__ __align__(128) float boxes[];
  __shared__ uint64_t full[K5_STAGES];
  const int t = threadIdx.x;
  float wx[4], wy[8][4];
  keys_weights((float)(t & 31) * (1.0f / 32.0f), wx);
#pragma unroll
  for (int p = 0; p < 8; ++p) keys_weights((float)p * 0.125f, wy[p]);

  auto origin = [&](int tile, int& plane, int& y0, int& x0) {
    plane = tile / tiles_plane;
    const int rest = tile - plane * tiles_plane, ty = rest / tiles_x;
    y0 = ty * K5_TH;
    x0 = (rest - ty * tiles_x) * K5_TW;
  };
  auto load = [&](int tile, int stage) {   // one thread: TMA of the tile's box
    int plane, y0, x0;
    origin(tile, plane, y0, x0);
    tma_load_3d(boxes + stage * K5_STAGE, &map, &full[stage], K5_BH * K5_BW * 4, x0, y0, plane);
  };
  if (TMA) {
    if (t == 0) {
      for (int s = 0; s < K5_STAGES; ++s) mbar_init(&full[s]);
      for (int s = 0; s + 1 < K5_STAGES; ++s)
        if (blockIdx.x + s * gridDim.x < ntiles) load(blockIdx.x + s * gridDim.x, s);
    }
    __syncthreads();
  }

  int k = 0;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++k) {
    int plane, y0, x0;
    origin(tile, plane, y0, x0);
    const int stage = TMA ? k % K5_STAGES : 0;
    float* box = boxes + stage * K5_STAGE;
    if (TMA) {
      // The stage of the tile K5_STAGES - 1 ahead was freed by the barrier
      // that ended the last iteration.
      const int next = tile + (K5_STAGES - 1) * gridDim.x;
      if (t == 0 && next < ntiles) load(next, (k + K5_STAGES - 1) % K5_STAGES);
      mbar_wait(&full[stage], (k / K5_STAGES) & 1);
    } else {
      // Coalesced plain loads, zero past the frame (32-bit offsets: checked
      // by the wrapper).
      const float* src = img + (int64_t)plane * H * W;
#pragma unroll
      for (int r = 0; r < K5_BH; ++r) {
        const int y = y0 + r;
        box[r * K5_BW + t] = y < H && x0 + t < W ? __ldg(src + y * W + x0 + t) : 0.0f;
        if (t < K5_BW - K5_TW) {
          const int x = x0 + K5_TW + t;
          box[r * K5_BW + K5_TW + t] = y < H && x < W ? __ldg(src + y * W + x) : 0.0f;
        }
      }
      __syncthreads();
    }

    const float* col = box + t;
    auto row_sum = [&](int r) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s += wx[i] * col[r * K5_BW + i];
      return s;
    };
    const int x = x0 + t;
    float* dst = out + (int64_t)plane * Ho * Wo + x;
    float h0 = row_sum(0), h1 = row_sum(1), h2 = row_sum(2);
#pragma unroll
    for (int r = 0; r < K5_TH; ++r) {
      if (y0 + r >= Ho) break;
      const float h3 = row_sum(r + 3);
      const float* w = wy[r & 7];
      float v = 0.0f;
      v += w[0] * h0;
      v += w[1] * h1;
      v += w[2] * h2;
      v += w[3] * h3;
      if (x < Wo) dst[(y0 + r) * Wo] = v;
      h0 = h1;
      h1 = h2;
      h2 = h3;
    }
    __syncthreads();   // every thread is done with the box: its stage can be refilled
  }
}

// cuTensorMapEncodeTiled, a CUDA driver API call, reached through the runtime
// (no -lcuda on the link line).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

}  // namespace ica

// img [B, C, H, W] -> out [B, C, H - 3, W - 3], f32 (H, W >= 4). tma: load
// the boxes by TMA (the wrapper checks W % 4 == 0 and a 16-B aligned img).
extern "C" int ica_warp_floor(const float* img, float* out, int B, int C, int H, int W, int tma,
                              void* stream) {
  using namespace ica;
  const int Ho = H - 3, Wo = W - 3;
  const int tiles_x = (Wo + K5_TW - 1) / K5_TW, tiles_plane = tiles_x * ((Ho + K5_TH - 1) / K5_TH);
  const int ntiles = tiles_plane * B * C;
  cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap map{};
  if (!tma) {
    warp_floor_kernel<false><<<ntiles, K5_THREADS, K5_STAGE * 4, s>>>(
        map, img, out, H, W, Ho, Wo, tiles_x, tiles_plane, ntiles);
    return (int)cudaGetLastError();
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B * C};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)H * W * 4};
  const cuuint32_t box[3] = {K5_BW, K5_BH, 1}, step[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)img, dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // The persistent grid: as many blocks as fit at once on the card the
  // launch goes to, found on that card's first launch and kept per device
  // ordinal (the cards of one process may differ). The attribute is set
  // per device too. Two threads that race on a device's first launch both
  // find the same value.
  const int smem = K5_STAGES * K5_STAGE * 4;
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> resident_on[MAX_DEVICES];   // 0: not found yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int resident = dev < MAX_DEVICES ? resident_on[dev].load(std::memory_order_relaxed) : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(warp_floor_kernel<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, warp_floor_kernel<true>,
                                                             K5_THREADS, smem)) != cudaSuccess)
      return (int)err;
    resident = sms * per_sm;
    if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES) resident_on[dev].store(resident, std::memory_order_relaxed);
  }
  const int grid = ntiles < resident ? ntiles : resident;
  warp_floor_kernel<true><<<grid, K5_THREADS, smem, s>>>(map, img, out, H, W, Ho, Wo, tiles_x,
                                                         tiles_plane, ntiles);
  return (int)cudaGetLastError();
}
