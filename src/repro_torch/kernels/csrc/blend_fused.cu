// Fused contribution-aware tile blend (the VRU array) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/render.py::blend_tiles_fused
// (body `_fused_blend_kernel`): front-to-back alpha blending of each 16x16
// tile's compacted, depth-ordered list, gated per entry by `valid`, by the
// entry's mini-tile CAT bit at the pixel and by alpha >= 1/255, with
// tile-level early termination, a per-tile occupied-block bound, resumable
// carried state (t0/acc0/p0/b0) for spill passes, and the work counters the
// kernel measures itself.
//
// What bounds it: operations. When nothing terminates, every pass evaluates
// T*256*K pixel-entry pairs (1.07G at 1920x1088 with K = 512), each about
// 30 fp32 operations including one expf, while device memory moves only
// about 0.4 GB a pass. The design keeps everything a pixel touches on chip:
//   * one 256-thread block per tile and one thread per pixel, so the
//     transmittance, colour and counters of a pixel live in registers for
//     the whole pass;
//   * a tile's list is staged through shared memory one K_BLK = 128 chunk
//     at a time (features, colour, valid, the 16 mini-tile bits: ~7.7 KB),
//     read as broadcasts by all 256 pixels;
//   * each pixel blends strictly front to back, entry by entry, with the
//     operation order of core/raster.py's fold (w = T*a; rgb += w*col;
//     T *= 1-a) — not the TPU kernel's in-block cumprod + matmul, which
//     lane lockstep forced there;
//   * termination is a block-wide vote (__syncthreads_or) on T >= T_EPS at
//     each chunk boundary; a chunk runs iff it lies below the tile's
//     occupied-block bound and some pixel is still alive, which keeps the
//     reference's 128-entry accounting of kblocks_processed.
// entry_alive is a per-entry OR over the block: a warp vote per entry into
// shared memory, folded over the 8 warps after the chunk.
//
// Built without --use_fast_math and with -fmad=false, so expf is the
// accurate one and no multiply-add is contracted: the kernel agrees with
// the plain PyTorch version on the card to an ulp or two.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 256;    // 16x16 tile, one thread per pixel
constexpr int kBlk = 128;       // K_BLK: list entries staged per chunk
constexpr int kMiniTiles = 16;  // 4x4 mini-tiles per tile
constexpr int kWarps = kPixels / 32;

__global__ void __launch_bounds__(kPixels) blend_fused_kernel(
    const float* __restrict__ pix,      // (T, 256, 2) pixel centers
    const float* __restrict__ feat,     // (T, K, 8) mx my cxx cxy cyy op 0 0
    const float* __restrict__ colors,   // (T, K, 3)
    const int8_t* __restrict__ valid,   // (T, K)
    const int8_t* __restrict__ allow,   // (T, K, 16)
    const int* __restrict__ kbound,     // (T,) occupied K_BLK chunks
    const float* __restrict__ t0,       // (T, 256) carried transmittance
    const float* __restrict__ acc0,     // (T, 256, 3) carried colour
    const float* __restrict__ p0,       // (T, 256) carried processed
    const float* __restrict__ b0,       // (T, 256) carried blended
    float* __restrict__ rgb_out, float* __restrict__ trans_out,
    float* __restrict__ proc_out, float* __restrict__ blnd_out,
    int8_t* __restrict__ alive_out,     // (T, K)
    int* __restrict__ kproc_out,        // (T,)
    int k_len, float alpha_min, float alpha_max, float t_eps) {
  __shared__ float s_feat[kBlk][6];
  __shared__ float s_col[kBlk][3];
  __shared__ __align__(16) uint8_t s_allow[kBlk][kMiniTiles];
  __shared__ uint8_t s_valid[kBlk];
  __shared__ uint8_t s_warp_alive[kWarps][kBlk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane_id = p & 31;
  const long long tp = static_cast<long long>(t) * kPixels + p;
  const long long row = static_cast<long long>(t) * k_len;
  const float px = pix[2 * tp];
  const float py = pix[2 * tp + 1];
  const int mt = (p >> 6) * 4 + ((p & 15) >> 2);  // pixel's mini-tile
  float trans = t0[tp];
  float r = acc0[3 * tp], g = acc0[3 * tp + 1], b = acc0[3 * tp + 2];
  float proc = p0[tp], blnd = b0[tp];
  const int bound = kbound[t];
  const int n_chunks = (k_len + kBlk - 1) / kBlk;

  int j = 0;
  for (; j < n_chunks; ++j) {
    // The vote is also the barrier that keeps the staging below from
    // overwriting a chunk other warps are still reading.
    const int any_alive = __syncthreads_or(trans >= t_eps);
    if (j >= bound || !any_alive) break;
    const int k0 = j * kBlk;
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
      const bool alive = trans >= t_eps;
      const float w = trans * a;
      r = r + w * s_col[kk][0];
      g = g + w * s_col[kk][1];
      b = b + w * s_col[kk][2];
      proc += (lane && alive) ? 1.f : 0.f;
      blnd += (a > 0.f && alive) ? 1.f : 0.f;
      const unsigned any = __any_sync(0xffffffffu, alive);
      if (lane_id == 0) s_warp_alive[warp][kk] = static_cast<uint8_t>(any);
      trans = trans * (1.f - a);
    }
    __syncthreads();
    if (p < kBlk && k0 + p < k_len) {
      uint8_t al = 0;
      for (int w = 0; w < kWarps; ++w) al |= s_warp_alive[w][p];
      alive_out[row + k0 + p] = static_cast<int8_t>(al && s_valid[p]);
    }
  }
  // Chunks that did not run saw no live entry.
  for (int k = j * kBlk + p; k < k_len; k += kPixels) alive_out[row + k] = 0;

  rgb_out[3 * tp] = r;
  rgb_out[3 * tp + 1] = g;
  rgb_out[3 * tp + 2] = b;
  trans_out[tp] = trans;
  proc_out[tp] = proc;
  blnd_out[tp] = blnd;
  if (p == 0) kproc_out[t] = j;
}

}  // namespace

// Plain C entry point for ctypes: device pointers of contiguous tensors and
// the caller's cudaStream_t. Returns the launch's cudaError_t (0 = success).
extern "C" int blend_tiles_fused_launch(
    const void* pix, const void* feat, const void* colors, const void* valid,
    const void* allow, const void* kbound, const void* t0, const void* acc0,
    const void* p0, const void* b0, void* rgb_out, void* trans_out,
    void* proc_out, void* blnd_out, void* alive_out, void* kproc_out,
    int n_tiles, int k_len, float alpha_min, float alpha_max, float t_eps,
    void* stream) {
  if (n_tiles == 0) return 0;
  blend_fused_kernel<<<n_tiles, kPixels, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pix), static_cast<const float*>(feat),
      static_cast<const float*>(colors), static_cast<const int8_t*>(valid),
      static_cast<const int8_t*>(allow), static_cast<const int*>(kbound),
      static_cast<const float*>(t0), static_cast<const float*>(acc0),
      static_cast<const float*>(p0), static_cast<const float*>(b0),
      static_cast<float*>(rgb_out), static_cast<float*>(trans_out),
      static_cast<float*>(proc_out), static_cast<float*>(blnd_out),
      static_cast<int8_t*>(alive_out), static_cast<int*>(kproc_out), k_len,
      alpha_min, alpha_max, t_eps);
  return static_cast<int>(cudaGetLastError());
}
