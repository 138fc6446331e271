// Dense Mini-Tile CAT (the dense-mask oracle's CTU) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/prtu.py::prtu_cat_mask (body
// `_prtu_kernel` / `_alg1_hits`): for every (mini-tile m, Gaussian g) pair
// of the frame it evaluates Alg. 1's four corner weights of g on m's pixel
// rectangle and writes one int8 hit flag, into a row-major (M, N) mask.
//
// What bounds it: operations. Every pair costs about 44 fp32 operations
// plus, under a fp8 delta, four non-saturating e4m3 conversions (a
// software routine), and writes one byte; the operands are a few bytes per
// row and per column. The design keeps the column's data in registers and
// the row's data in shared memory:
//   * one thread per Gaussian column: it loads the Gaussian's mean, conic,
//     lhs = ln(255 o) and spiky flag once, quantizes them once, and loops
//     over a block of kRows mini-tile rows;
//   * the block's kRows leader-pixel pairs, quantized to the coordinate
//     precision once, sit in shared memory and are read as broadcasts;
//   * a row's flags are written by consecutive threads to consecutive
//     bytes of the row, so each warp stores one coalesced 32-byte segment.
// The TPU kernel's (128, 128) VMEM blocks and padding to block multiples do
// not carry over: the grid covers the ragged edge and masks it, so there is
// no padded column (the reference's padded Gaussians carry lhs = -inf and
// never hit; so do culled ones here).
//
// Indexing: M * N reaches 8.6e9 at 1024x1024 with 131072 Gaussians, past
// int32, so every output offset is computed in 64 bits (the wrapper checks
// M and N each fit in int32).
//
// Numerics: Alg. 1 of alg1.cuh, one rounding per step, built with
// -fmad=false, shared with the entry-stream kernel prtu_entry.cu: a dense
// mask gathered at a compacted entry equals that kernel's bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "alg1.cuh"

namespace {

constexpr int kThreads = 256;  // Gaussian columns per block
constexpr int kRows = 128;     // mini-tile rows per block

__global__ void __launch_bounds__(kThreads) prtu_dense_kernel(
    const float* __restrict__ p_top,   // (M, 2) image-space leader coords
    const float* __restrict__ p_bot,   // (M, 2)
    const float* __restrict__ mu,      // (N, 2)
    const float* __restrict__ conic,   // (N, 3)
    const float* __restrict__ lhs,     // (N,) ln(255 o), -inf if culled
    const int8_t* __restrict__ spiky,  // (N,)
    int8_t* __restrict__ out,          // (M, N)
    int m_rows, int n_cols, int mode, int coord_prec, int delta_prec,
    int mul_prec, int acc_prec, float k_slack) {
  __shared__ float s_lead[kRows][4];   // quantized ptx, pty, pbx, pby
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, m_rows - m0);
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const long long m = m0 + r;
    s_lead[r][0] = alg1::quant(p_top[2 * m], coord_prec);
    s_lead[r][1] = alg1::quant(p_top[2 * m + 1], coord_prec);
    s_lead[r][2] = alg1::quant(p_bot[2 * m], coord_prec);
    s_lead[r][3] = alg1::quant(p_bot[2 * m + 1], coord_prec);
  }
  __syncthreads();
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_cols) return;
  const float2 mg = reinterpret_cast<const float2*>(mu)[g];
  const float mu_x = alg1::quant(mg.x, coord_prec);
  const float mu_y = alg1::quant(mg.y, coord_prec);
  const float cxx = alg1::quant(conic[3 * g], coord_prec);
  const float cxy = alg1::quant(conic[3 * g + 1], coord_prec);
  const float cyy = alg1::quant(conic[3 * g + 2], coord_prec);
  const float l = lhs[g];
  const bool sp = spiky[g] != 0;
  int8_t* col = out + static_cast<long long>(m0) * n_cols + g;
  for (int r = 0; r < rows; ++r) {
    const bool hit = alg1::hit(s_lead[r][0], s_lead[r][1], s_lead[r][2],
                               s_lead[r][3], mu_x, mu_y, cxx, cxy, cyy, l,
                               sp, mode, delta_prec, mul_prec, acc_prec,
                               k_slack);
    col[static_cast<long long>(r) * n_cols] = static_cast<int8_t>(hit);
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of
// contiguous tensors; `stream` is the caller's cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int prtu_cat_mask_launch(
    const void* p_top, const void* p_bot, const void* mu, const void* conic,
    const void* lhs, const void* spiky, void* out, int m_rows, int n_cols,
    int mode, int coord_prec, int delta_prec, int mul_prec, int acc_prec,
    float k_slack, void* stream) {
  if (m_rows == 0 || n_cols == 0) return 0;
  const dim3 grid((n_cols + kThreads - 1) / kThreads,
                  (m_rows + kRows - 1) / kRows);
  prtu_dense_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p_top), static_cast<const float*>(p_bot),
      static_cast<const float*>(mu), static_cast<const float*>(conic),
      static_cast<const float*>(lhs), static_cast<const int8_t*>(spiky),
      static_cast<int8_t*>(out), m_rows, n_cols, mode, coord_prec,
      delta_prec, mul_prec, acc_prec, k_slack);
  return static_cast<int>(cudaGetLastError());
}
