// K1's device code, shared by the production kernel (fused_iter.cu) and its
// measurement-only ablation variants (fused_iter_ablate.cu). ABL, a set of
// common.cuh's ABL_* knobs, is 0 in production; every knob is resolved at
// compile time, so the production kernel holds no branch of the variants.
#pragma once

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

// ABL_CHEAPMOM: accumulate_pixel with one x factor for every power (no
// power chain), as the TPU variant's iota stands in for its power matrix.
__device__ __forceinline__ void accumulate_pixel_flat(float wx[MAXK][DEG], const float m[MAXK],
                                                      int K, float xn) {
#pragma unroll
  for (int a = 0; a < DEG; ++a) {
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k < K) wx[k][a] += m[k] * xn;
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
template <int NC, int ABL = 0>
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
    BasicSampler<ABL> s;
    if constexpr ((ABL & ABL_NOEPI) != 0) {
      // The warp alone: every channel sampled, the samples kept alive in
      // one moment; no mask, template, rho' or x powers.
      s.setup(gx, gy, a.H, a.W);
#pragma unroll
      for (int c = 0; c < C; ++c) wx[0][0] += s.eval(src + c * pi, a.H, a.W);
      continue;
    }
    const float valid = (gx >= d && gx <= xhi && gy >= d && gy <= yhi) ? 1.0f : 0.0f;
    if constexpr ((ABL & ABL_EPIONLY) == 0) s.setup(gx, gy, a.H, a.W);
    // The template is read once: streaming loads (evict first) leave L1
    // to the taps.
    const float* t = tpl + x;
    float u = 0.0f, v = 0.0f, t2 = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // ABL_EPIONLY: no warp, and iw is set, not read from anywhere.
      const float iw = (ABL & ABL_EPIONLY) != 0 ? 0.0f : s.eval(src + c * pi, a.H, a.W);
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
      const float rho = (ABL & ABL_NORHO) != 0 ? t2 * lam_b : rhop(t2, lam2, a.loss);
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
    if constexpr ((ABL & ABL_CHEAPMOM) != 0)
      accumulate_pixel_flat(wx, mk, K, (float)x * a.inv_l);
    else
      accumulate_pixel(wx, mk, K, (float)x * a.inv_l);
  }
}

// A block's work, pair-major over (pair, band): each warp sums its row's
// moments, reduced once at the row's end, and the block writes the band's
// [K, 5, 5] partial. blk_buf holds K1_ROWS * MAXK * NMOM floats of shared
// memory.
template <int NC, int ABL = 0>
__device__ __forceinline__ void k1_band(const K1Args& a, float* blk_buf) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int K = a.loss > 0 ? 5 : 2;
  const int pair = blockIdx.x / a.nbands, band = blockIdx.x - pair * a.nbands;
  const int row = band * K1_ROWS + warp;
  float acc[DEG] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (row < a.Ho) {
    float wx[MAXK][DEG] = {};
    k1_row<NC, ABL>(a, pair, row, wx, lane);
    finish_tile_row(wx, K, (float)(row + a.yoff) * a.inv_l, acc, lane);
  }
  finish_block<K1_ROWS>(acc, K, blk_buf, a.partial, pair, a.nbands, band, warp, lane);
}

}  // namespace ica
