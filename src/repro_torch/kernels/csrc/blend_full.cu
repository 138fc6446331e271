// Full-sweep tile blend (the unfused VRU baseline) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/render.py::blend_tiles (body
// `_blend_kernel`): front-to-back alpha blending of every slot of each
// 16x16 tile's list, gated per entry by `valid`, by the entry's mini-tile
// CAT bit at the pixel and by alpha >= 1/255 — with no early termination,
// no occupied-block bound and no work counters. It is the baseline the
// fused kernel (blend_fused.cu) is measured against.
//
// What bounds it: instructions on the lanes the data needs. A (pixel,
// entry) lane whose mini-tile bit is off, or whose slot is invalid, has
// a = 0 and leaves the pixel's colour and transmittance bit-identical, so
// only the set lanes need their ~26 fp32 operations and one accurate expf
// (at 1024x1024, 18% of the T*256*K lanes). The design evaluates those
// lanes and reads only the features they need:
//   * one 256-thread block per tile; warp w holds the 4x8 pixels of
//     mini-tiles {2w, 2w+1} (lanes 0-15 and 16-31), a pixel's
//     transmittance and colour stay in registers for the whole sweep, and
//     outputs are indexed by the pixel's row-major index in the tile;
//   * the list is staged through shared memory K_BLK = 128 entries at a
//     time, masks first: a chunk's 16 allow bytes and valid byte per entry
//     become one 16-bit mask (0 where the slot is invalid), and only the
//     entries with a non-zero mask copy their features and colour, with
//     cp.async, one chunk ahead of the blend (double-buffered, as in
//     blend_fused.cu; the masks are loaded two chunks ahead). A chunk with
//     no bit set anywhere (__syncthreads_or) is not blended at all, so the
//     empty tail of a compacted list costs a read of its masks. Valid
//     entries need not form a prefix;
//   * each warp ballots the chunk's masks for its two bits and walks, in
//     order, the entries either bit is set for (blend_fused.cu's walk), a
//     lane whose own bit is off folding a = 0. Measured on the H100 at
//     1024x1024, this walk issues 4% more lane slots than the needed lanes
//     (neighbouring mini-tiles' bits mostly coincide) and beat a walk in
//     which each half-warp follows its own mini-tile's list (divergent, 6%
//     slower) and one in which the two half-warps compute alpha for two
//     entries of one mini-tile and both fold both (2.3x slower);
//   * a step's instructions are cut where the result allows: the three
//     staged arrays share one stride (one address a step), and cxx and
//     cyy are halved once at staging, which is exact;
//   * each pixel blends strictly front to back with the operation order of
//     core/raster.py's fold (w = T*a; rgb += w*col; T *= 1-a), not the TPU
//     kernel's in-block cumprod + matmul, which lane lockstep forced there.
// -Xptxas -v for sm_90a (printed by kernels/build.py at build time): 40
// registers, 12,800 bytes of shared memory (two stages), no spills: six
// blocks fit an SM. A step of the walk is 45 instructions, so the kernel
// is bound by instruction issue, not by its operations' fp32 rate.
// Built without --use_fast_math and with -fmad=false, so expf is the
// accurate one and no multiply-add is contracted: skipping a lane with
// a = 0 changes no bit, and the kernel equals the plain PyTorch fold on the
// card to an ulp or two.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 256;    // 16x16 tile
constexpr int kBlk = 128;       // K_BLK: list entries staged per chunk
constexpr int kGroups = kBlk / 32;  // ballot words per chunk

struct Stage {                  // one staged chunk
  float4 geo[kBlk];             // mean x, mean y, cxx / 2, cxy
  float4 rest[kBlk];            // cyy / 2, opacity, red, green
  float4 blue[kBlk];            // blue, unused
  uint16_t mask[kBlk];          // allow bits, 0 where the slot is invalid
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
__device__ __forceinline__ uint32_t pack_allow(uint4 a) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    bits |= static_cast<uint32_t>(((w[i >> 2] >> (8 * (i & 3))) & 0xffu)
                                  != 0u) << i;
  return bits;
}

__global__ void __launch_bounds__(kPixels) blend_full_kernel(
    const float* __restrict__ pix,      // (T, 256, 2) pixel centers
    const float* __restrict__ feat,     // (T, K, 8) mx my cxx cxy cyy op 0 0
    const float* __restrict__ colors,   // (T, K, 3)
    const int8_t* __restrict__ valid,   // (T, K)
    const int8_t* __restrict__ allow,   // (T, K, 16)
    float* __restrict__ rgb_out,        // (T, 256, 3)
    float* __restrict__ trans_out,      // (T, 256)
    int k_len, float alpha_min, float alpha_max) {
  __shared__ Stage stage[2];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Warp w: pixel rows 4(w/2)..+3, columns 8(w%2)..+7; lanes 0-15 in
  // mini-tile 2w, lanes 16-31 in 2w+1, each row-major within its 4x4.
  const int py_local = 4 * (warp >> 1) + ((lane & 15) >> 2);
  const int px_local = 8 * (warp & 1) + 4 * (lane >> 4) + (lane & 3);
  const long long tp = static_cast<long long>(t) * kPixels
                       + 16 * py_local + px_local;
  const long long row = static_cast<long long>(t) * k_len;
  const float px = pix[2 * tp];
  const float py = pix[2 * tp + 1];
  float trans = 1.f;
  float r = 0.f, g = 0.f, b = 0.f;

  // Thread kk < 128 stages entry kk of a chunk: its allow row and valid
  // byte into registers (two chunks ahead), then its packed mask and, if
  // the mask is non-zero, its features and colour (one chunk ahead), whose
  // cxx and cyy it halves once they have landed.
  uint4 allow_next = make_uint4(0u, 0u, 0u, 0u);
  int8_t valid_next = 0;
  auto load_masks = [&](int chunk) {
    if (tid < kBlk) {
      const int k = chunk * kBlk + tid;
      if (k < k_len) {
        const long long e = row + k;
        allow_next = reinterpret_cast<const uint4*>(allow)[e];
        valid_next = valid[e];
      } else {  // ragged last chunk: slots past K never blend
        allow_next = make_uint4(0u, 0u, 0u, 0u);
        valid_next = 0;
      }
    }
  };
  auto stage_chunk = [&](Stage& s, int chunk) {
    bool need = false;
    if (tid < kBlk) {
      const uint32_t m = valid_next != 0 ? pack_allow(allow_next) : 0u;
      s.mask[tid] = static_cast<uint16_t>(m);
      need = m != 0u;
      if (need) {
        const long long e = row + chunk * kBlk + tid;
        cp_async16(&s.geo[tid], feat + 8 * e);
        cp_async8(&s.rest[tid], feat + 8 * e + 4);
        cp_async4(&s.rest[tid].z, colors + 3 * e);
        cp_async4(&s.rest[tid].w, colors + 3 * e + 1);
        cp_async4(&s.blue[tid].x, colors + 3 * e + 2);
      }
    }
    cp_async_commit();
    return need;
  };
  // After cp.async.wait_all a thread sees its own copies: it halves the
  // entry it staged before the barrier publishes the chunk. Halving is
  // exact, so 0.5 (cxx d0^2 + cyy d1^2) = (cxx/2) d0^2 + (cyy/2) d1^2 bit
  // for bit (a scaling by 2^-1 commutes with rounding).
  auto land = [&](Stage& s, bool need) {
    cp_async_wait_all();
    if (need) {
      s.geo[tid].z *= 0.5f;
      s.rest[tid].x *= 0.5f;
    }
  };

  const int n_chunks = (k_len + kBlk - 1) / kBlk;
  load_masks(0);
  bool need = stage_chunk(stage[0], 0);
  if (n_chunks > 1) load_masks(1);
  land(stage[0], need);
  int run = __syncthreads_or(need);  // chunk 0 has a set lane; staged
  for (int j = 0; j < n_chunks; ++j) {
    const Stage& cur = stage[j & 1];
    need = false;
    if (j + 1 < n_chunks) {
      // The other buffer was last read in chunk j-1's blend, which the
      // barrier that ended iteration j-1 has closed.
      need = stage_chunk(stage[(j + 1) & 1], j + 1);
      if (j + 2 < n_chunks) load_masks(j + 2);
    }
    if (run) {
#pragma unroll 1
      for (int gi = 0; gi < kGroups; ++gi) {
        // The group's entries with either of the warp's two bits set, in
        // order; `mine` holds the bits of this lane's mini-tile.
        const uint32_t m = cur.mask[32 * gi + lane];
        const uint32_t wa = __ballot_sync(0xffffffffu,
                                          (m >> (2 * warp)) & 1u);
        const uint32_t wb = __ballot_sync(0xffffffffu,
                                          (m >> (2 * warp + 1)) & 1u);
        const uint32_t mine = lane < 16 ? wa : wb;
        uint32_t todo = wa | wb;
        while (todo) {
          const int kk = 32 * gi + __ffs(todo) - 1;
          const bool on = (mine >> (kk & 31)) & 1u;
          todo &= todo - 1;
          const float4 f = cur.geo[kk];
          const float4 f1 = cur.rest[kk];
          const float d0 = px - f.x;
          const float d1 = py - f.y;
          const float e = (f.z * (d0 * d0) + f1.x * (d1 * d1))
                          + (f.w * d0) * d1;
          float a = fminf(f1.y * expf(-e), alpha_max);
          a = (on && a >= alpha_min) ? a : 0.f;
          const float w = trans * a;
          r = r + w * f1.z;
          g = g + w * f1.w;
          b = b + w * cur.blue[kk].x;
          trans = trans * (1.f - a);
        }
      }
    }
    land(stage[(j + 1) & 1], need);
    run = __syncthreads_or(need);
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
