// Alg. 1 of the Mini-Tile CAT (paper §IV-C), one (pixel rectangle,
// Gaussian) pair, shared by the two PRTU kernels: prtu_entry.cu (K1, the
// survivor-stream CTU) and prtu_dense.cu (K4, the dense-mask oracle). It is
// the CUDA form of `_alg1_hits` in src/repro/kernels/prtu.py.
//
// Numerics: the result must equal the reference bit for bit, so every
// step rounds once, in the order of the CTU datapath:
//   * fp16 steps round with __float2half_rn and widen with __half2float;
//   * fp8 steps convert with __nv_cvt_float_to_fp8(x, __NV_NOSAT,
//     __NV_E4M3), which gives NaN for |x| > 464 and for +-inf exactly as
//     the reference's float8_e4m3fn cast does (a saturating conversion
//     would clamp to 448), and widen through __nv_cvt_fp8_to_halfraw;
//   * every kernel including this header is built with -fmad=false: under
//     FULL_FP32 nothing is quantized, and a contracted a*b+c would move
//     near-tie comparisons lhs > E*(1-slack) by an ulp;
//   * an lhs of -inf (an invalid entry, a culled Gaussian) never hits, and
//     a NaN weight compares false, so a pixel more than 464 px from the
//     Gaussian's centre never hits under a fp8 delta either.
#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

namespace alg1 {

// Precision codes (PrecisionScheme fields): 0 fp32, 1 fp16, 2 fp8.
__device__ __forceinline__ float quant(float x, int kind) {
  if (kind == 1) return __half2float(__float2half_rn(x));
  if (kind == 2) {
    const __nv_fp8_storage_t s =
        __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3);
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(s, __NV_E4M3)));
  }
  return x;
}

// Whether the Gaussian passes the CAT for one pixel rectangle. The leader
// coordinates (ptx, pty) / (pbx, pby) of the main diagonal, the mean and
// the conic are already quantized to the coordinate precision. `mode` is
// the sampling mode: 0 uniform_dense, 1 uniform_sparse, 2 smooth_focused,
// 3 spiky_focused. k_slack = 1 - slack.
__device__ __forceinline__ bool hit(float ptx, float pty, float pbx,
                                    float pby, float mu_x, float mu_y,
                                    float cxx, float cxy, float cyy,
                                    float lhs, bool spiky, int mode,
                                    int delta_prec, int mul_prec,
                                    int acc_prec, float k_slack) {
  // line 1: subtract at coord precision, convert to delta precision
  const float dtx = quant(ptx - mu_x, delta_prec);
  const float dty = quant(pty - mu_y, delta_prec);
  const float dbx = quant(pbx - mu_x, delta_prec);
  const float dby = quant(pby - mu_y, delta_prec);
  // lines 2-3: shared separable terms
  const float s_top_x = quant(quant(0.5f * quant(dtx * dtx, mul_prec),
                                    mul_prec) * cxx, mul_prec);
  const float s_top_y = quant(quant(0.5f * quant(dty * dty, mul_prec),
                                    mul_prec) * cyy, mul_prec);
  const float s_bot_x = quant(quant(0.5f * quant(dbx * dbx, mul_prec),
                                    mul_prec) * cxx, mul_prec);
  const float s_bot_y = quant(quant(0.5f * quant(dby * dby, mul_prec),
                                    mul_prec) * cyy, mul_prec);
  // lines 4-5: cross terms
  const float t0 = quant(quant(dtx * dty, mul_prec) * cxy, mul_prec);
  const float t1 = quant(quant(dbx * dty, mul_prec) * cxy, mul_prec);
  const float t2 = quant(quant(dtx * dby, mul_prec) * cxy, mul_prec);
  const float t3 = quant(quant(dbx * dby, mul_prec) * cxy, mul_prec);
  // lines 6-7: adders at acc precision
  const float e0 = quant(quant(s_top_x + s_top_y, acc_prec) + t0, acc_prec);
  const float e1 = quant(quant(s_bot_x + s_top_y, acc_prec) + t1, acc_prec);
  const float e2 = quant(quant(s_top_x + s_bot_y, acc_prec) + t2, acc_prec);
  const float e3 = quant(quant(s_bot_x + s_bot_y, acc_prec) + t3, acc_prec);

  const bool h0 = lhs > e0 * k_slack;
  const bool h1 = lhs > e1 * k_slack;
  const bool h2 = lhs > e2 * k_slack;
  const bool h3 = lhs > e3 * k_slack;
  const bool dense = h0 || h1 || h2 || h3;
  const bool sparse = h0 || h3;  // main diagonal only
  switch (mode) {
    case 0: return dense;
    case 1: return sparse;
    case 2: return spiky ? sparse : dense;
    default: return spiky ? dense : sparse;
  }
}

}  // namespace alg1
