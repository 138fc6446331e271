// Full-sweep tile blend (the unfused VRU baseline) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/render.py::blend_tiles (body
// `_blend_kernel`): front-to-back alpha blending of every slot of each
// 16x16 tile's list, gated per entry by `valid`, by the entry's mini-tile
// CAT bit at the pixel and by alpha >= 1/255 — with no early termination,
// no occupied-block bound and no work counters. It is the baseline the
// fused kernel (blend_fused.cu) is measured against.
//
// What bounds it: operations. Every pass evaluates T*256*K pixel-entry
// pairs, each about 32 fp32 operations including one expf, against a few
// hundred bytes of operands per entry. The design is the fused kernel's
// skeleton without its vote:
//   * one 256-thread block per tile and one thread per pixel; the pixel's
//     transmittance and colour stay in registers for the whole sweep;
//   * the tile's list is staged through shared memory K_BLK = 128 entries
//     at a time (features, colour, valid, the 16 mini-tile bits) and read
//     as broadcasts by all 256 pixels;
//   * each pixel blends strictly front to back, entry by entry, with the
//     operation order of core/raster.py's fold (w = T*a; rgb += w*col;
//     T *= 1-a) — not the TPU kernel's in-block cumprod + matmul, which
//     lane lockstep forced there.
// Built without --use_fast_math and with -fmad=false, so expf is the
// accurate one and no multiply-add is contracted: the kernel agrees with
// the plain PyTorch fold on the card to an ulp or two.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 256;    // 16x16 tile, one thread per pixel
constexpr int kBlk = 128;       // K_BLK: list entries staged per chunk
constexpr int kMiniTiles = 16;  // 4x4 mini-tiles per tile

__global__ void __launch_bounds__(kPixels) blend_full_kernel(
    const float* __restrict__ pix,      // (T, 256, 2) pixel centers
    const float* __restrict__ feat,     // (T, K, 8) mx my cxx cxy cyy op 0 0
    const float* __restrict__ colors,   // (T, K, 3)
    const int8_t* __restrict__ valid,   // (T, K)
    const int8_t* __restrict__ allow,   // (T, K, 16)
    float* __restrict__ rgb_out,        // (T, 256, 3)
    float* __restrict__ trans_out,      // (T, 256)
    int k_len, float alpha_min, float alpha_max) {
  __shared__ float s_feat[kBlk][6];
  __shared__ float s_col[kBlk][3];
  __shared__ __align__(16) uint8_t s_allow[kBlk][kMiniTiles];
  __shared__ uint8_t s_valid[kBlk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const long long tp = static_cast<long long>(t) * kPixels + p;
  const long long row = static_cast<long long>(t) * k_len;
  const float px = pix[2 * tp];
  const float py = pix[2 * tp + 1];
  const int mt = (p >> 6) * 4 + ((p & 15) >> 2);  // pixel's mini-tile
  float trans = 1.f;
  float r = 0.f, g = 0.f, b = 0.f;

  for (int k0 = 0; k0 < k_len; k0 += kBlk) {
    __syncthreads();  // the previous chunk is no longer being read
    if (p < kBlk) {
      const int k = k0 + p;
      if (k < k_len) {
        const long long e = row + k;
        const float4 f0 = reinterpret_cast<const float4*>(feat)[2 * e];
        const float4 f1 = reinterpret_cast<const float4*>(feat)[2 * e + 1];
        s_feat[p][0] = f0.x; s_feat[p][1] = f0.y; s_feat[p][2] = f0.z;
        s_feat[p][3] = f0.w; s_feat[p][4] = f1.x; s_feat[p][5] = f1.y;
        s_col[p][0] = colors[3 * e];
        s_col[p][1] = colors[3 * e + 1];
        s_col[p][2] = colors[3 * e + 2];
        s_valid[p] = valid[e] != 0;
        *reinterpret_cast<uint4*>(s_allow[p]) =
            reinterpret_cast<const uint4*>(allow)[e];
      } else {  // ragged last chunk: slots past K never blend
        s_valid[p] = 0;
        *reinterpret_cast<uint4*>(s_allow[p]) = make_uint4(0u, 0u, 0u, 0u);
        for (int c = 0; c < 6; ++c) s_feat[p][c] = 0.f;
        for (int c = 0; c < 3; ++c) s_col[p][c] = 0.f;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kBlk; ++kk) {
      const bool lane = s_valid[kk] && s_allow[kk][mt];
      const float d0 = px - s_feat[kk][0];
      const float d1 = py - s_feat[kk][1];
      const float e = 0.5f * (s_feat[kk][2] * (d0 * d0)
                              + s_feat[kk][4] * (d1 * d1))
                      + (s_feat[kk][3] * d0) * d1;
      float a = fminf(s_feat[kk][5] * expf(-e), alpha_max);
      a = (lane && a >= alpha_min) ? a : 0.f;
      const float w = trans * a;
      r = r + w * s_col[kk][0];
      g = g + w * s_col[kk][1];
      b = b + w * s_col[kk][2];
      trans = trans * (1.f - a);
    }
  }
  rgb_out[3 * tp] = r;
  rgb_out[3 * tp + 1] = g;
  rgb_out[3 * tp + 2] = b;
  trans_out[tp] = trans;
}

}  // namespace

// Plain C entry point for ctypes: device pointers of contiguous tensors and
// the caller's cudaStream_t. Returns the launch's cudaError_t (0 = success).
extern "C" int blend_tiles_launch(
    const void* pix, const void* feat, const void* colors, const void* valid,
    const void* allow, void* rgb_out, void* trans_out, int n_tiles,
    int k_len, float alpha_min, float alpha_max, void* stream) {
  if (n_tiles == 0) return 0;
  blend_full_kernel<<<n_tiles, kPixels, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pix), static_cast<const float*>(feat),
      static_cast<const float*>(colors), static_cast<const int8_t*>(valid),
      static_cast<const int8_t*>(allow), static_cast<float*>(rgb_out),
      static_cast<float*>(trans_out), k_len, alpha_min, alpha_max);
  return static_cast<int>(cudaGetLastError());
}
