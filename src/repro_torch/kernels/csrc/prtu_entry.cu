// Entry-stream Mini-Tile CAT (the CTU) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/prtu.py::prtu_entry_cat_mask
// (body `_prtu_entry_kernel` / `_alg1_hits`): for every compacted list
// entry (tile t, slot k) it evaluates Alg. 1's four corner weights E0..E3
// of the Gaussian against each of the tile's 16 mini-tile pixel rectangles
// and writes one int8 hit flag per mini-tile, (T, K, 16).
//
// What bounds it: memory traffic. Each entry reads 25 bytes of features
// (mu 8, conic 12, lhs 4, spiky 1) and writes 16 bytes of mask, against
// about 40 fp32 operations per (entry, mini-tile) pair — far below the
// card's operations-per-byte balance point. The design therefore gives
// one thread to one entry: the thread loads its features once, keeps them
// in registers across the 16 mini-tiles, and writes its 16 flags as one
// aligned 16-byte store, so consecutive threads load consecutive feature
// records and store consecutive 16-byte rows (coalesced both ways). The
// 16 leader-pixel pairs of the tile-local mini-tiles sit in shared memory.
//
// Numerics: the per-pair arithmetic is Alg. 1 of alg1.cuh, one rounding
// per step, built with -fmad=false (see that header): the mask equals the
// reference bit for bit, invalid entries carry lhs = -inf and never hit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "alg1.cuh"

namespace {

constexpr int kMiniTiles = 16;
constexpr int kThreads = 256;

// Sampling modes: 0 uniform_dense, 1 uniform_sparse, 2 smooth_focused,
// 3 spiky_focused.
__global__ void __launch_bounds__(kThreads) prtu_entry_kernel(
    const float* __restrict__ p_top,    // (16, 2) tile-local leader coords
    const float* __restrict__ p_bot,    // (16, 2)
    const float* __restrict__ origins,  // (T, 2) tile pixel origins
    const float* __restrict__ mu,       // (T, K, 2)
    const float* __restrict__ conic,    // (T, K, 3)
    const float* __restrict__ lhs,      // (T, K) ln(255 o), -inf if invalid
    const int8_t* __restrict__ spiky,   // (T, K)
    uint4* __restrict__ out,            // (T, K, 16) int8 as 16-byte rows
    int n_entries, int k_per_tile, int mode, int coord_prec,
    int delta_prec, int mul_prec, int acc_prec, float k_slack) {
  __shared__ float s_top[2 * kMiniTiles];
  __shared__ float s_bot[2 * kMiniTiles];
  if (threadIdx.x < 2 * kMiniTiles) {
    s_top[threadIdx.x] = p_top[threadIdx.x];
    s_bot[threadIdx.x] = p_bot[threadIdx.x];
  }
  __syncthreads();
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_entries) return;
  const int t = e / k_per_tile;
  const float ox = origins[2 * t];
  const float oy = origins[2 * t + 1];
  const float2 m = reinterpret_cast<const float2*>(mu)[e];
  const float mu_x = alg1::quant(m.x, coord_prec);
  const float mu_y = alg1::quant(m.y, coord_prec);
  const float cxx = alg1::quant(conic[3 * e], coord_prec);
  const float cxy = alg1::quant(conic[3 * e + 1], coord_prec);
  const float cyy = alg1::quant(conic[3 * e + 2], coord_prec);
  const float l = lhs[e];
  const bool sp = spiky[e] != 0;

  uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll 4
  for (int j = 0; j < kMiniTiles; ++j) {
    const bool hit = alg1::hit(
        alg1::quant(ox + s_top[2 * j], coord_prec),
        alg1::quant(oy + s_top[2 * j + 1], coord_prec),
        alg1::quant(ox + s_bot[2 * j], coord_prec),
        alg1::quant(oy + s_bot[2 * j + 1], coord_prec), mu_x, mu_y, cxx,
        cxy, cyy, l, sp, mode, delta_prec, mul_prec, acc_prec, k_slack);
    words[j >> 2] |= static_cast<uint32_t>(hit) << (8 * (j & 3));
  }
  out[e] = make_uint4(words[0], words[1], words[2], words[3]);
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of
// contiguous tensors; `stream` is the caller's cudaStream_t. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int prtu_entry_cat_mask_launch(
    const void* p_top, const void* p_bot, const void* origins,
    const void* mu, const void* conic, const void* lhs, const void* spiky,
    void* out, int n_entries, int k_per_tile, int mode, int coord_prec,
    int delta_prec, int mul_prec, int acc_prec, float k_slack,
    void* stream) {
  if (n_entries == 0) return 0;
  const int blocks = (n_entries + kThreads - 1) / kThreads;
  prtu_entry_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p_top), static_cast<const float*>(p_bot),
      static_cast<const float*>(origins), static_cast<const float*>(mu),
      static_cast<const float*>(conic), static_cast<const float*>(lhs),
      static_cast<const int8_t*>(spiky), static_cast<uint4*>(out),
      n_entries, k_per_tile, mode, coord_prec, delta_prec, mul_prec,
      acc_prec, k_slack);
  return static_cast<int>(cudaGetLastError());
}
