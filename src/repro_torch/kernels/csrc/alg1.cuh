// Alg. 1 of the Mini-Tile CAT (paper §IV-C), shared by the two PRTU
// kernels: prtu_entry.cu (K1, the survivor-stream CTU) and prtu_dense.cu
// (K4, the dense-mask oracle). It is the CUDA form of `_alg1_hits` in
// src/repro/kernels/prtu.py, cut into its steps (delta, separable term,
// cross term, corner sum, decision) so that `hit` below and the two
// kernels' hoisted loops compose the same arithmetic in the same rounding
// order.
//
// Numerics: the result must equal the reference bit for bit, so every
// step rounds once, in the order of the CTU datapath:
//   * fp16 steps round with __float2half_rn / __floats2half2_rn and widen
//     with __half2float / __half22float2;
//   * fp8 steps use Hopper's hardware conversion, which exists only in its
//     saturating form: cvt.rn.satfinite.e4m3x2.f32, widened exactly with
//     cvt.rn.f16x2.e4m3x2. The reference's float8_e4m3fn cast gives NaN
//     for |x| > 464 (past the midpoint above the largest finite 448) and
//     for +-inf, where the saturating conversion would give +-448, so the
//     result is replaced by NaN wherever !(|x| <= 464): that covers
//     |x| > 464, +-inf and NaN (fault F1). For |x| <= 464 the saturating
//     and the non-saturating conversions round alike;
//   * the two-value forms (`quant2` and the steps built on it) convert a
//     pair in one instruction; each lane rounds exactly as the one-value
//     form does. `fp8_quant_h2` is quant2's fp8 rounding left as float16
//     values (every e4m3 value is one), for prtu_dense.cu's float16 path;
//   * every kernel including this header is built with -fmad=false: under
//     FULL_FP32 nothing is quantized, and a contracted a*b+c would move
//     near-tie comparisons lhs > E*(1-slack) by an ulp;
//   * an lhs of -inf (an invalid entry, a culled Gaussian) never hits, and
//     a NaN weight compares false, so a pixel more than 464 px from the
//     Gaussian's centre never hits under a fp8 delta either.
#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

namespace alg1 {

// Precision codes (PrecisionScheme fields): 0 fp32, 1 fp16, 2 fp8.
constexpr float kFp8Overflow = 464.f;

__device__ __forceinline__ float fp8_nan() {
  return __int_as_float(0x7fc00000);
}

// (lo, hi) rounded to e4m3, saturating, as float16 values (every e4m3 value
// is one). In `cvt.rn.satfinite.e4m3x2.f32 d, a, b` the first source lands
// in the upper byte of d; `cvt.rn.f16x2.e4m3x2` keeps the byte order in the
// halves.
__device__ __forceinline__ __half2 fp8_satfinite_h2(float lo, float hi) {
  unsigned short pair;
  asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;" : "=h"(pair) : "f"(hi),
      "f"(lo));
  unsigned int halves;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(halves) : "h"(pair));
  return *reinterpret_cast<const __half2*>(&halves);
}

// The same widened back to float.
__device__ __forceinline__ float2 fp8_satfinite2(float lo, float hi) {
  return __half22float2(fp8_satfinite_h2(lo, hi));
}

// quant2(lo, hi, 2) as float16 values: the e4m3 rounding, NaN wherever
// !(|x| <= 464).
__device__ __forceinline__ __half2 fp8_quant_h2(float lo, float hi) {
  const __half2 q = fp8_satfinite_h2(lo, hi);
  const __half nan = __ushort_as_half(0x7e00);
  return __halves2half2(
      fabsf(lo) <= kFp8Overflow ? __low2half(q) : nan,
      fabsf(hi) <= kFp8Overflow ? __high2half(q) : nan);
}

__device__ __forceinline__ float2 quant2(float a, float b, int kind) {
  if (kind == 1) return __half22float2(__floats2half2_rn(a, b));
  if (kind == 2) {
    float2 q = fp8_satfinite2(a, b);
    if (!(fabsf(a) <= kFp8Overflow)) q.x = fp8_nan();
    if (!(fabsf(b) <= kFp8Overflow)) q.y = fp8_nan();
    return q;
  }
  return make_float2(a, b);
}

__device__ __forceinline__ float quant(float x, int kind) {
  if (kind == 1) return __half2float(__float2half_rn(x));
  if (kind == 2) return quant2(x, 0.f, 2).x;
  return x;
}

// line 1: p - mu at coordinate precision, converted to delta precision;
// the pair (x, y) of one leader.
__device__ __forceinline__ float2 delta2(float px, float py, float mu_x,
                                         float mu_y, int delta_prec) {
  return quant2(px - mu_x, py - mu_y, delta_prec);
}

// lines 2-3: the separable terms q(q(0.5 q(d d)) c) of a pair, each lane
// with its own conic entry (x with cxx, y with cyy).
__device__ __forceinline__ float2 separable2(float2 d, float cx, float cy,
                                             int mul) {
  const float2 sq = quant2(d.x * d.x, d.y * d.y, mul);
  const float2 half_sq = quant2(0.5f * sq.x, 0.5f * sq.y, mul);
  return quant2(half_sq.x * cx, half_sq.y * cy, mul);
}

// lines 4-5: the cross terms q(q(a b) cxy) of two corners.
__device__ __forceinline__ float2 cross2(float2 a, float2 b, float cxy,
                                         int mul) {
  const float2 ab = quant2(a.x * b.x, a.y * b.y, mul);
  return quant2(ab.x * cxy, ab.y * cxy, mul);
}

// lines 6-7: the corner weights q(q(sx + sy) + t) of two corners.
__device__ __forceinline__ float2 corner2(float2 sx, float2 sy, float2 t,
                                          int acc) {
  const float2 s = quant2(sx.x + sy.x, sx.y + sy.y, acc);
  return quant2(s.x + t.x, s.y + t.y, acc);
}

// The decision from E0..E3 (e01 = (E0, E1), e23 = (E2, E3)). `mode` is the
// sampling mode: 0 uniform_dense, 1 uniform_sparse, 2 smooth_focused,
// 3 spiky_focused. k_slack = 1 - slack.
__device__ __forceinline__ bool decide(float2 e01, float2 e23, float lhs,
                                       float k_slack, bool spiky, int mode) {
  const bool h0 = lhs > e01.x * k_slack;
  const bool h1 = lhs > e01.y * k_slack;
  const bool h2 = lhs > e23.x * k_slack;
  const bool h3 = lhs > e23.y * k_slack;
  const bool dense = h0 || h1 || h2 || h3;
  const bool sparse = h0 || h3;  // main diagonal only
  switch (mode) {
    case 0: return dense;
    case 1: return sparse;
    case 2: return spiky ? sparse : dense;
    default: return spiky ? dense : sparse;
  }
}

// Whether the Gaussian passes the CAT for one pixel rectangle. The leader
// coordinates (ptx, pty) / (pbx, pby) of the main diagonal, the mean and
// the conic are already quantized to the coordinate precision.
__device__ __forceinline__ bool hit(float ptx, float pty, float pbx,
                                    float pby, float mu_x, float mu_y,
                                    float cxx, float cxy, float cyy,
                                    float lhs, bool spiky, int mode,
                                    int delta_prec, int mul_prec,
                                    int acc_prec, float k_slack) {
  const float2 dt = delta2(ptx, pty, mu_x, mu_y, delta_prec);  // dtx, dty
  const float2 db = delta2(pbx, pby, mu_x, mu_y, delta_prec);  // dbx, dby
  const float2 st = separable2(dt, cxx, cyy, mul_prec);  // s_top_x, _y
  const float2 sb = separable2(db, cxx, cyy, mul_prec);  // s_bot_x, _y
  const float2 dx = make_float2(dt.x, db.x);
  const float2 t01 = cross2(dx, make_float2(dt.y, dt.y), cxy, mul_prec);
  const float2 t23 = cross2(dx, make_float2(db.y, db.y), cxy, mul_prec);
  const float2 sx = make_float2(st.x, sb.x);
  const float2 e01 = corner2(sx, make_float2(st.y, st.y), t01, acc_prec);
  const float2 e23 = corner2(sx, make_float2(sb.y, sb.y), t23, acc_prec);
  return decide(e01, e23, lhs, k_slack, spiky, mode);
}

}  // namespace alg1
