// K6: the solver trip's update, one launch a trip.
//
// Replaces no TPU kernel: the JAX package leaves the update to XLA, which
// fuses it inside its lax.while_loop. In the port it was about 480 ATen
// launches a trip on [B]-sized tensors (models/ic.py::iterate before this
// kernel), and the host's time to issue them paced every trip. Per pair,
// from K1's moments:
//   1. assemble H (lower triangle) and b with the constant contraction
//      tensors of ops/kernels/normal_eq.py::_assembly (robust: H from
//      moments 0-2, b from 3-4; quadratic: H is the level's hoisted Hessian,
//      b from moments 0-1);
//   2. anneal lambda (robust loss with lam <= 0, active pairs only);
//   3. solve as ops/normal_equations.py::solve_normal: identity on the
//      padded diagonal, cholesky_solve8's factorization and substitutions
//      in its order, the preconditioner divided out, a non-finite dp set to
//      0, err = ||dp||;
//   4. compose p o dp^-1 as ops/transforms.py::compose_inverse;
//   5. the divergence guard of trip_update.py::lost_overlap (five probes,
//      a margin, the finite checks; a lost pair reverts to p0);
//   6. commit p, error, niters, still (false on the last iteration),
//      diverged, the next trip's motion matrix for K1, and the count of
//      pairs still active for the loop's one host read.
// Every step after the assembly rounds each operation as the plain op chain
// does (one ATen kernel an operation): products, sums and quotients go
// through the round-to-nearest intrinsics, so nvcc contracts nothing into an
// FMA. Only the assembly's summation order and the norm's differ from the
// einsum and vector_norm; the 3x3 product sums its three terms in order.
//
// Bound on the H100: neither bytes (B * ~1.5 KB) nor flops (~6000 a pair);
// one launch replaces the host's ~480. One warp a pair: its lanes assemble
// the 44 entries of H's lower triangle and b in parallel (75 or 50 terms
// each, the contraction tensors staged in shared memory once a block), then
// lane 0 runs the serial 8x8 algebra. The still count is reduced per block
// (__syncthreads_count) and added with one atomic a block into count[cur];
// the kernel zeroes count[1 - cur], which the next trip adds into, so the
// loop needs no memset launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ica {

constexpr int K6_WARPS = 8;
constexpr int K6_THREADS = K6_WARPS * 32;
constexpr int NP = 8;               // padded parameters
constexpr int NMOM6 = 25;           // moments per map (5 x 5)
constexpr int NTRI = NP * (NP + 1) / 2;
constexpr int NSYS = NTRI + NP;     // H's lower triangle, then b

// TransformType values (ops/transforms.py).
constexpr int TRANSLATION = 1, EUCLIDEAN = 2, SIMILARITY = 3, AFFINITY = 4, HOMOGRAPHY = 5;

struct K6Args {
  const float* m;         // [B, K, 8, 8] moments (K1)
  const float* t_h;       // [8, 8, 3, 5, 5] (robust) or null
  const float* t_b;       // [8, 2, 5, 5]
  const float* h_quad;    // [B, 8, 8] (quadratic) or null
  const float* live;      // [8] 0/1
  const float* scale;     // [8] preconditioner
  const float* p0;        // [B, 8] warm start (the guard's revert)
  float* p;               // [B, 8]      in and out
  float* err;             // [B]         in and out
  float* lam;             // [B]         in and out
  int* niters;            // [B]         in and out
  uint8_t* active;        // [B] bool    in: this trip's; out: still
  uint8_t* diverged;      // [B] bool    in and out
  float* mat;             // [B, 3, 3]   out: M(p) for the next K1
  int* count;             // [2]         count[cur] += still; count[1 - cur] = 0
  int B, K, ttype, anneal, guard, last, cur, height, width;
  float tol, lambda_n, lambda_ratio, xlo, xhi, ylo, yhi;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// The math library's cosf, sinf and atan2f, as ATen's kernels call them,
// kept out of line: inlined, they made ptxas spill 12 bytes of the kernel's
// registers; called, nothing spills.
__device__ __noinline__ float cos_k6(float x) { return cosf(x); }
__device__ __noinline__ float sin_k6(float x) { return sinf(x); }
__device__ __noinline__ float atan2_k6(float y, float x) { return atan2f(y, x); }

// params_to_matrix: the 3x3 motion of padded parameters q, row-major.
__device__ __forceinline__ void to_matrix(const float q[NP], int ttype, float m[9]) {
  m[6] = 0.0f; m[7] = 0.0f; m[8] = 1.0f;
  switch (ttype) {
    case TRANSLATION:
      m[0] = 1.0f; m[1] = 0.0f; m[2] = q[0]; m[3] = 0.0f; m[4] = 1.0f; m[5] = q[1];
      break;
    case EUCLIDEAN: {
      const float c = cos_k6(q[2]), s = sin_k6(q[2]);
      m[0] = c; m[1] = -s; m[2] = q[0]; m[3] = s; m[4] = c; m[5] = q[1];
      break;
    }
    case SIMILARITY:
      m[0] = add(1.0f, q[2]); m[1] = -q[3]; m[2] = q[0];
      m[3] = q[3]; m[4] = add(1.0f, q[2]); m[5] = q[1];
      break;
    case AFFINITY:
      m[0] = add(1.0f, q[2]); m[1] = q[3]; m[2] = q[0];
      m[3] = q[4]; m[4] = add(1.0f, q[5]); m[5] = q[1];
      break;
    default:  // HOMOGRAPHY
      m[0] = add(1.0f, q[0]); m[1] = q[1]; m[2] = q[2];
      m[3] = q[3]; m[4] = add(1.0f, q[4]); m[5] = q[5];
      m[6] = q[6]; m[7] = q[7];
      break;
  }
}

// compose_inverse: p o dp^-1 = params(M(p) adj(M(dp)) / w), or p where
// w^2 <= 1e-10; TRANSLATION is p - dp.
__device__ __forceinline__ void compose(const float p[NP], const float dp[NP], int ttype,
                                        float out[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) out[i] = p[i];
  if (ttype == TRANSLATION) {
    out[0] = sub(p[0], dp[0]);
    out[1] = sub(p[1], dp[1]);
    return;
  }
  float a[9], d[9], j[9], u[9];
  to_matrix(p, ttype, a);
  to_matrix(dp, ttype, d);
  j[0] = sub(mul(d[4], d[8]), mul(d[5], d[7]));
  j[1] = sub(mul(d[2], d[7]), mul(d[1], d[8]));
  j[2] = sub(mul(d[1], d[5]), mul(d[2], d[4]));
  j[3] = sub(mul(d[5], d[6]), mul(d[3], d[8]));
  j[4] = sub(mul(d[0], d[8]), mul(d[2], d[6]));
  j[5] = sub(mul(d[2], d[3]), mul(d[0], d[5]));
  j[6] = sub(mul(d[3], d[7]), mul(d[4], d[6]));
  j[7] = sub(mul(d[1], d[6]), mul(d[0], d[7]));
  j[8] = sub(mul(d[0], d[4]), mul(d[1], d[3]));
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      u[r * 3 + c] = add(add(mul(a[r * 3], j[c]), mul(a[r * 3 + 1], j[3 + c])),
                         mul(a[r * 3 + 2], j[6 + c]));
  const float w = u[8];
  if (!(mul(w, w) > 1e-10f)) return;
#pragma unroll
  for (int i = 0; i < 9; ++i) u[i] = dvd(u[i], w);
#pragma unroll
  for (int i = 0; i < NP; ++i) out[i] = 0.0f;
  out[0] = u[2];
  out[1] = u[5];
  switch (ttype) {
    case EUCLIDEAN:
      out[2] = atan2_k6(u[3], u[0]);
      break;
    case SIMILARITY:
      out[2] = sub(u[0], 1.0f); out[3] = u[3];
      break;
    case AFFINITY:
      out[2] = sub(u[0], 1.0f); out[3] = u[1]; out[4] = u[3]; out[5] = sub(u[4], 1.0f);
      break;
    default:  // HOMOGRAPHY
      out[0] = sub(u[0], 1.0f); out[1] = u[1]; out[2] = u[2];
      out[3] = u[3]; out[4] = sub(u[4], 1.0f); out[5] = u[5];
      out[6] = u[6]; out[7] = u[7];
      break;
  }
}

// lost_overlap: every probe of x'(x; q) lies outside the inflated frame or
// is non-finite, or q is non-finite.
__device__ __forceinline__ bool lost(const float q[NP], const K6Args& a) {
  float m[9];
  to_matrix(q, a.ttype, m);
  const float xr = (float)(a.width - 1), yr = (float)(a.height - 1);
  const float xs[5] = {0.0f, xr, 0.0f, xr, 0.5f * xr};
  const float ys[5] = {0.0f, 0.0f, yr, yr, 0.5f * yr};
  bool any_ok = false;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    float gx = add(add(mul(m[0], xs[k]), mul(m[1], ys[k])), m[2]);
    float gy = add(add(mul(m[3], xs[k]), mul(m[4], ys[k])), m[5]);
    if (a.ttype == HOMOGRAPHY) {
      const float d = add(add(mul(m[6], xs[k]), mul(m[7], ys[k])), m[8]);
      gx = dvd(gx, d);
      gy = dvd(gy, d);
    }
    any_ok |= gx >= a.xlo && gx <= a.xhi && gy >= a.ylo && gy <= a.yhi && isfinite(gx) &&
              isfinite(gy);
  }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < NP; ++i) finite &= isfinite(q[i]);
  return !any_ok || !finite;
}

// Steps 2-6 for one pair, from its assembled system (sys: H's lower
// triangle row by row, then b). Returns whether the pair goes on.
__device__ __forceinline__ bool update_pair(const K6Args& a, int pair, const float* sys) {
  const float* b = sys + NTRI;
  float live[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) live[i] = a.live[i];
  const bool act = a.active[pair] != 0;

  if (a.anneal && act) {
    const float lam = a.lam[pair];
    if (lam > a.lambda_n) {
      const float nxt = mul(lam, a.lambda_ratio);
      a.lam[pair] = nxt < a.lambda_n ? a.lambda_n : nxt;
    }
  }

  // (H + diag(1 - live)) dp = b by cholesky_solve8's unrolled order.
  float l[NP][NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float s = add(sys[j * (j + 1) / 2 + j], sub(1.0f, live[j]));
#pragma unroll
    for (int k = 0; k < j; ++k) s = sub(s, mul(l[j][k], l[j][k]));
    const float ljj = __fsqrt_rn(s);
    l[j][j] = ljj;
    const float inv = dvd(1.0f, ljj);
#pragma unroll
    for (int i = j + 1; i < NP; ++i) {
      float t = add(sys[i * (i + 1) / 2 + j], 0.0f);
#pragma unroll
      for (int k = 0; k < j; ++k) t = sub(t, mul(l[i][k], l[j][k]));
      l[i][j] = mul(t, inv);
    }
  }
  float y[NP], dp[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = sub(s, mul(l[i][k], y[k]));
    y[i] = dvd(s, l[i][i]);
  }
#pragma unroll
  for (int i = NP - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < NP; ++k) s = sub(s, mul(l[k][i], dp[k]));
    dp[i] = dvd(s, l[i][i]);
  }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    dp[i] = dvd(dp[i], a.scale[i]);
    finite &= isfinite(dp[i]);
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    dp[i] = mul(finite ? dp[i] : 0.0f, live[i]);
    ss = add(ss, mul(dp[i], dp[i]));
  }
  const float err = __fsqrt_rn(ss);

  float p[NP], pn[NP];
  float* pp = a.p + (int64_t)pair * NP;
#pragma unroll
  for (int i = 0; i < NP; ++i) p[i] = pp[i];
  compose(p, dp, a.ttype, pn);
  const bool bad = a.guard && act && lost(pn, a);
  if (bad) {
#pragma unroll
    for (int i = 0; i < NP; ++i) pn[i] = a.p0[(int64_t)pair * NP + i];
  }
  if (act) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      p[i] = pn[i];
      pp[i] = pn[i];
    }
    a.err[pair] = err;
    a.niters[pair] += 1;
  }
  const bool still = act && err > a.tol && !bad && !a.last;
  a.active[pair] = still;
  if (bad) a.diverged[pair] = 1;
  float mt[9];
  to_matrix(p, a.ttype, mt);
#pragma unroll
  for (int i = 0; i < 9; ++i) a.mat[(int64_t)pair * 9 + i] = mt[i];
  return still;
}

__global__ void __launch_bounds__(K6_THREADS) trip_update_kernel(const K6Args a) {
  __shared__ float th[NP * NP * 3 * NMOM6];
  __shared__ float tb[NP * 2 * NMOM6];
  __shared__ float mom[K6_WARPS][5 * NMOM6];
  __shared__ float sys[K6_WARPS][NSYS];
  const bool robust = a.t_h != nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = blockIdx.x * K6_WARPS + warp;
  const bool valid = pair < a.B;

  if (robust)
    for (int i = threadIdx.x; i < NP * NP * 3 * NMOM6; i += K6_THREADS) th[i] = a.t_h[i];
  for (int i = threadIdx.x; i < NP * 2 * NMOM6; i += K6_THREADS) tb[i] = a.t_b[i];
  if (valid)
    for (int t = lane; t < a.K * NMOM6; t += 32) {
      const int k = t / NMOM6, r = t % NMOM6;
      mom[warp][t] = a.m[((int64_t)pair * a.K + k) * 64 + (r / 5) * 8 + r % 5];
    }
  __syncthreads();

  if (valid) {
    for (int t = lane; t < NSYS; t += 32) {
      float s = 0.0f;
      if (t < NTRI) {
        int n = 0;
        while ((n + 1) * (n + 2) / 2 <= t) ++n;
        const int c = t - n * (n + 1) / 2;
        if (robust) {
          const float* coef = th + (n * NP + c) * 3 * NMOM6;
          for (int q = 0; q < 3 * NMOM6; ++q) s = add(s, mul(mom[warp][q], coef[q]));
        } else {
          s = a.h_quad[(int64_t)pair * NP * NP + n * NP + c];
        }
      } else {
        const float* coef = tb + (t - NTRI) * 2 * NMOM6;
        const float* mb = mom[warp] + (robust ? 3 * NMOM6 : 0);
        for (int q = 0; q < 2 * NMOM6; ++q) s = add(s, mul(mb[q], coef[q]));
      }
      sys[warp][t] = s;
    }
  }
  __syncwarp();
  const bool still = valid && lane == 0 && update_pair(a, pair, sys[warp]);
  const int n = __syncthreads_count(still);
  if (threadIdx.x == 0 && n > 0) atomicAdd(a.count + a.cur, n);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.count[1 - a.cur] = 0;
}

}  // namespace ica

// One trip's update of B pairs in place (see K6Args for the operands; a
// null t_h selects the quadratic path, which reads h_quad). cur is 0 or 1.
extern "C" int ica_trip_update(const float* m, const float* t_h, const float* t_b,
                               const float* h_quad, const float* live, const float* scale,
                               const float* p0, float* p, float* err, float* lam, int* niters,
                               uint8_t* active, uint8_t* diverged, float* mat, int* count, int B,
                               int K, int ttype, int anneal, int guard, int last, int cur,
                               int height, int width, float tol, float lambda_n,
                               float lambda_ratio, float xlo, float xhi, float ylo, float yhi,
                               void* stream) {
  using namespace ica;
  if (B <= 0) return 0;
  const K6Args a{m, t_h, t_b, h_quad, live, scale, p0, p, err, lam, niters, active, diverged,
                 mat, count, B, K, ttype, anneal, guard, last, cur, height, width, tol, lambda_n,
                 lambda_ratio, xlo, xhi, ylo, yhi};
  trip_update_kernel<<<(B + K6_WARPS - 1) / K6_WARPS, K6_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
