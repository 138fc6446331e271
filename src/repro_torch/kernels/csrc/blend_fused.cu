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
// What bounds it: operations on the lanes it evaluates. A pixel-entry lane
// costs about 30 fp32 operations including one expf; on the first hd1080
// pass only about a quarter of the lanes of the K-blocks run have their
// mini-tile bit set, and a lane whose bit is off contributes nothing. The
// design evaluates a lane only where its warp needs it:
//   * one 256-thread block per tile; warp w holds the 4x8 pixel block of
//     mini-tiles {2w, 2w+1} (mini-tile row w/2, columns 2(w%2) and
//     2(w%2)+1), a pixel's transmittance, colour and counters live in
//     registers for the whole pass, and outputs stay indexed by the
//     pixel's row-major index in the tile;
//   * a tile's list is staged through shared memory one K_BLK = 128 chunk
//     at a time, double-buffered: chunk j+1 is copied with cp.async
//     (features as one float4 and one float2 per entry, colours apart)
//     while chunk j blends, and its 16 allow bytes and valid byte are
//     packed into one 16-bit mask per entry. Chunk 0 is staged after the
//     first vote, so a tile that enters the pass dead reads no entry;
//   * each warp ballots the chunk's masks for the entries whose 2-bit
//     field for its mini-tiles is non-zero and walks only those, in
//     ascending order. An entry a warp skips has a = 0 at all of its
//     pixels, so rgb, T, processed and blended are bit-identical to a walk
//     over every entry; a dead pixel of a running tile keeps blending, as
//     in the reference;
//   * each pixel blends strictly front to back with the operation order of
//     core/raster.py's fold (w = T*a; rgb += w*col; T *= 1-a), not the TPU
//     kernel's in-block cumprod + matmul, which lane lockstep forced there;
//   * termination is a block-wide vote (__syncthreads_or) on T >= T_EPS at
//     each chunk boundary, which is also the barrier that protects the
//     buffer being refilled; a chunk runs iff it lies below the tile's
//     occupied-block bound and some pixel is still alive, which keeps the
//     reference's 128-entry accounting of kblocks_processed.
// entry_alive without a vote per entry: transmittance never increases, so
// "some pixel of the tile is alive before entry kk" holds for a prefix of
// each chunk. Each pixel records the last entry it was alive before; the
// block's maximum (__reduce_max_sync, then shared memory) ends the prefix.
// -Xptxas -v for sm_90a: 46 registers, 10,048 bytes of shared memory (two
// stages), no spills: five blocks fit an SM.
//
// Built without --use_fast_math and with -fmad=false, so expf is the
// accurate one and no multiply-add is contracted: the kernel agrees with
// the plain PyTorch version on the card to an ulp or two.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 256;    // 16x16 tile
constexpr int kBlk = 128;       // K_BLK: list entries staged per chunk
constexpr int kWarps = kPixels / 32;
constexpr int kGroups = kBlk / 32;  // ballot words per chunk

struct Stage {                  // one staged chunk
  float4 geo[kBlk];             // mean x, mean y, cxx, cxy
  float2 shape[kBlk];           // cyy, opacity
  float col[kBlk][3];
  uint16_t mask[kBlk];          // allow bits, 0 where the slot is invalid
  uint8_t valid[kBlk];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One bit per non-zero byte of the 16 allow bytes.
__device__ __forceinline__ uint16_t pack_allow(uint4 a) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    bits |= static_cast<uint32_t>(((w[i >> 2] >> (8 * (i & 3))) & 0xffu)
                                  != 0u) << i;
  return static_cast<uint16_t>(bits);
}

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
  __shared__ Stage stage[2];
  __shared__ int s_last[2][kWarps];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Warp w: pixel rows 4(w/2)..+3, columns 8(w%2)..+7; lanes 0-15 in
  // mini-tile 2w, lanes 16-31 in 2w+1, each row-major within its 4x4.
  const int py_local = 4 * (warp >> 1) + ((lane & 15) >> 2);
  const int px_local = 8 * (warp & 1) + 4 * (lane >> 4) + (lane & 3);
  const int my_bit = 2 * warp + (lane >> 4);   // the pixel's mini-tile
  const long long tp = static_cast<long long>(t) * kPixels
                       + 16 * py_local + px_local;
  const long long row = static_cast<long long>(t) * k_len;
  const float px = pix[2 * tp];
  const float py = pix[2 * tp + 1];
  float trans = t0[tp];
  float r = acc0[3 * tp], g = acc0[3 * tp + 1], b = acc0[3 * tp + 2];
  float proc = p0[tp], blnd = b0[tp];
  const int n_chunks = (k_len + kBlk - 1) / kBlk;
  const int n_run_max = min(kbound[t], n_chunks);

  // Staging: thread kk < 128 copies entry kk's features, thread 128 + kk
  // its colour; thread kk also loads its allow row and valid byte into
  // registers and packs them once the copies have landed.
  const int kk_own = tid & (kBlk - 1);
  uint4 allow_next = make_uint4(0u, 0u, 0u, 0u);
  int8_t valid_next = 0;
  auto fetch = [&](int chunk, Stage& s) {
    const int k = chunk * kBlk + kk_own;
    if (k < k_len) {
      const long long e = row + k;
      if (tid < kBlk) {
        cp_async16(&s.geo[kk_own], feat + 8 * e);
        cp_async8(&s.shape[kk_own], feat + 8 * e + 4);
        allow_next = reinterpret_cast<const uint4*>(allow)[e];
        valid_next = valid[e];
      } else {
        cp_async4(&s.col[kk_own][0], colors + 3 * e);
        cp_async4(&s.col[kk_own][1], colors + 3 * e + 1);
        cp_async4(&s.col[kk_own][2], colors + 3 * e + 2);
      }
    } else {  // ragged last chunk: slots past K never blend
      allow_next = make_uint4(0u, 0u, 0u, 0u);
      valid_next = 0;
    }
    cp_async_commit();
  };
  auto land = [&](Stage& s) {
    cp_async_wait_all();
    if (tid < kBlk) {
      s.valid[kk_own] = valid_next != 0;
      s.mask[kk_own] = valid_next != 0 ? pack_allow(allow_next) : 0;
    }
  };

  int j = 0;
  for (;; ++j) {
    // The vote is also the barrier after which chunk j's stage is visible
    // and the other buffer (chunk j-1's) is free to refill.
    const int any_alive = __syncthreads_or(trans >= t_eps);
    if (j > 0 && tid < kBlk && (j - 1) * kBlk + tid < k_len) {
      // Chunk j-1's entry_alive: valid and before the block's last-alive
      // entry.
      int last = -1;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) last = max(last, s_last[(j - 1) & 1][w]);
      alive_out[row + (j - 1) * kBlk + tid] = static_cast<int8_t>(
          stage[(j - 1) & 1].valid[tid] && tid <= last);
    }
    if (j >= n_run_max || !any_alive) break;
    if (j == 0) {  // chunk 0 is staged only once it is known to run
      fetch(0, stage[0]);
      land(stage[0]);
      __syncthreads();
    }
    Stage& cur = stage[j & 1];
    const bool prefetch = j + 1 < n_run_max;
    if (prefetch) fetch(j + 1, stage[(j + 1) & 1]);

    uint32_t todo[kGroups];
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
      todo[gi] = __ballot_sync(0xffffffffu,
                               (cur.mask[32 * gi + lane] >> (2 * warp)) & 3u);
    int last = trans >= t_eps ? kBlk - 1 : -1;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      uint32_t bits = todo[gi];
      while (bits) {
        const int kk = 32 * gi + __ffs(bits) - 1;
        bits &= bits - 1;
        const float4 f = cur.geo[kk];
        const float2 f1 = cur.shape[kk];
        const bool lane_on = (cur.mask[kk] >> my_bit) & 1u;
        const float d0 = px - f.x;
        const float d1 = py - f.y;
        const float e = 0.5f * (f.z * (d0 * d0) + f1.x * (d1 * d1))
                        + (f.w * d0) * d1;
        float a = fminf(f1.y * expf(-e), alpha_max);
        a = (lane_on && a >= alpha_min) ? a : 0.f;
        const bool alive = trans >= t_eps;
        const float w = trans * a;
        r = r + w * cur.col[kk][0];
        g = g + w * cur.col[kk][1];
        b = b + w * cur.col[kk][2];
        proc += (lane_on && alive) ? 1.f : 0.f;
        blnd += (a > 0.f && alive) ? 1.f : 0.f;
        trans = trans * (1.f - a);
        if (alive && !(trans >= t_eps)) last = kk;
      }
    }
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0) s_last[j & 1][warp] = last;
    if (prefetch) land(stage[(j + 1) & 1]);
  }
  // Chunks that did not run saw no live entry.
  for (int k = j * kBlk + tid; k < k_len; k += kPixels) alive_out[row + k] = 0;

  rgb_out[3 * tp] = r;
  rgb_out[3 * tp + 1] = g;
  rgb_out[3 * tp + 2] = b;
  trans_out[tp] = trans;
  proc_out[tp] = proc;
  blnd_out[tp] = blnd;
  if (tid == 0) kproc_out[t] = j;
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
