// Entry-stream Mini-Tile CAT (the CTU) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/prtu.py::prtu_entry_cat_mask
// (body `_prtu_entry_kernel` / `_alg1_hits`): for every compacted list
// entry (tile t, slot k) it evaluates Alg. 1's four corner weights E0..E3
// of the Gaussian against each of the tile's 16 mini-tile pixel rectangles
// and writes one int8 hit flag per mini-tile, (T, K, 16).
//
// What bounds it: instructions, not bytes. An entry reads 25 bytes of
// features (mu 8, conic 12, lhs 4, spiky 1) and writes 16 bytes of mask;
// a pass of 8160 x 512 entries moves 0.17 GB, 0.05 ms at 3.35 TB/s. Each
// valid entry costs 16 x 44 fp32 operations plus, under MIXED (coord
// fp16, delta fp8, mul fp16, acc fp16), one rounding per step: every
// rounding is a conversion and a widening, and conversions run at a
// fraction of the fp32 rate. The design cuts the instructions per entry:
//   * one thread per entry: features load once into registers, the 16
//     flags leave as one aligned 16-byte store, consecutive threads on
//     consecutive records (coalesced both ways);
//   * early exit: an entry with lhs = -inf (an empty slot, a culled
//     Gaussian) can never hit; it stores its zero row and returns before
//     any feature load. Valid entries are a prefix of each tile's list, so
//     whole warps retire together and an empty pass costs a read of lhs
//     and a write of the mask;
//   * hoisting: the 16 leaders lie on a 4x4 lattice (x fixed by the
//     mini-tile column, y by its row), so an entry has 4 distinct values
//     each of dtx, dty, dbx, dby and of the four separable terms. They are
//     computed once (16 coordinate, 16 delta and 48 separable-term
//     roundings instead of 64, 64 and 192); only the 64 cross terms and
//     64 corner sums remain per mini-tile;
//   * pairing: every rounding step goes through alg1.cuh's two-value forms
//     (one conversion instruction for two lanes), including Hopper's
//     hardware e4m3 conversion under a fp8 delta;
//   * the multiplier and adder precisions are template parameters (9
//     instances picked at launch), so no rounding step branches at run
//     time; the coordinate and delta precisions stay run-time (16 pair
//     roundings an entry).
// The lattice is checked, not assumed: warp 0 compares the 32 leader
// floats staged in shared memory (x equal down each column, y equal along
// each row, bit for bit, for p_top and p_bot). When they are not on the
// lattice the block runs Alg. 1 per mini-tile (`alg1::hit`), the same
// rounding steps, unhoisted; the branch is block-uniform.
// -Xptxas -v for sm_90a (printed by kernels/build.py at build time): the
// MIXED instance <1,1> uses 58 registers and 260 bytes of shared memory,
// the other instances 48-59 registers; none spills, so four 256-thread
// blocks fit an SM. It runs about 4x over its byte bound on a full pass:
// per valid entry some 170 paired conversions, 340 widenings and 460 fp32
// operations remain.
//
// Numerics: the arithmetic is alg1.cuh's steps, one rounding per step in
// the reference's order, built with -fmad=false: the mask equals the
// reference bit for bit, and invalid entries carry lhs = -inf and never
// hit.
//
// `alg1_quant_launch` is a test hook: it applies `alg1::quant` (one value)
// or `alg1::quant2` (consecutive pairs) to a float buffer, so the fp8
// conversion can be compared with the plain quantizer over every float32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "alg1.cuh"

namespace {

constexpr int kMiniTiles = 16;
constexpr int kLattice = 4;     // mini-tiles per tile row and column
constexpr int kThreads = 256;

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// Alg. 1 for the 16 mini-tiles of one entry, leaders on the 4x4 lattice.
// Mini-tile j = 4 r + c has its top leader at (tx[c], ty[r]) and its
// bottom leader at (bx[c], by[r]), all quantized to coordinate precision.
template <int kMul, int kAcc>
__device__ __forceinline__ void hits_on_lattice(
    const float (&tx)[kLattice], const float (&ty)[kLattice],
    const float (&bx)[kLattice], const float (&by)[kLattice], float mu_x,
    float mu_y, float cxx, float cxy, float cyy, float l, bool sp, int mode,
    int delta_prec, float k_slack, uint32_t (&words)[4]) {
  // Per lattice index i: (dtx of column i, dty of row i), the same at the
  // bottom, and their separable terms.
  float2 dt[kLattice], db[kLattice], st[kLattice], sb[kLattice];
#pragma unroll
  for (int i = 0; i < kLattice; ++i) {
    dt[i] = alg1::delta2(tx[i], ty[i], mu_x, mu_y, delta_prec);
    db[i] = alg1::delta2(bx[i], by[i], mu_x, mu_y, delta_prec);
    st[i] = alg1::separable2(dt[i], cxx, cyy, kMul);
    sb[i] = alg1::separable2(db[i], cxx, cyy, kMul);
  }
#pragma unroll
  for (int r = 0; r < kLattice; ++r) {
#pragma unroll
    for (int c = 0; c < kLattice; ++c) {
      const float2 dx = make_float2(dt[c].x, db[c].x);
      const float2 t01 =
          alg1::cross2(dx, make_float2(dt[r].y, dt[r].y), cxy, kMul);
      const float2 t23 =
          alg1::cross2(dx, make_float2(db[r].y, db[r].y), cxy, kMul);
      const float2 sx = make_float2(st[c].x, sb[c].x);
      const float2 e01 =
          alg1::corner2(sx, make_float2(st[r].y, st[r].y), t01, kAcc);
      const float2 e23 =
          alg1::corner2(sx, make_float2(sb[r].y, sb[r].y), t23, kAcc);
      const int j = kLattice * r + c;
      words[j >> 2] |= static_cast<uint32_t>(
                           alg1::decide(e01, e23, l, k_slack, sp, mode))
                       << (8 * (j & 3));
    }
  }
}

// Sampling modes: 0 uniform_dense, 1 uniform_sparse, 2 smooth_focused,
// 3 spiky_focused.
template <int kMul, int kAcc>
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
    int delta_prec, float k_slack) {
  __shared__ float s_top[2 * kMiniTiles];
  __shared__ float s_bot[2 * kMiniTiles];
  __shared__ int s_on_lattice;
  if (threadIdx.x < 2 * kMiniTiles) {
    s_top[threadIdx.x] = p_top[threadIdx.x];
    s_bot[threadIdx.x] = p_bot[threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // Lane m < 16 checks top leader m, lane 16 + m bottom leader m: its x
    // equals row 0's in its column, its y column 0's in its row.
    const float* s = threadIdx.x < kMiniTiles ? s_top : s_bot;
    const int m = threadIdx.x & (kMiniTiles - 1);
    const bool ok = same_bits(s[2 * m], s[2 * (m % kLattice)]) &&
                    same_bits(s[2 * m + 1], s[2 * (m - m % kLattice) + 1]);
    const int all = __all_sync(0xffffffffu, ok);
    if (threadIdx.x == 0) s_on_lattice = all;
  }
  __syncthreads();
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_entries) return;
  const float l = lhs[e];
  if (!(l > __uint_as_float(0xff800000u))) {
    // lhs = -inf (or NaN) never hits: -inf > x and NaN > x are false.
    out[e] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int t = e / k_per_tile;
  const float ox = origins[2 * t];
  const float oy = origins[2 * t + 1];
  const float2 m = reinterpret_cast<const float2*>(mu)[e];
  const float2 mq = alg1::quant2(m.x, m.y, coord_prec);
  const float2 cq = alg1::quant2(conic[3 * e], conic[3 * e + 2], coord_prec);
  const float cxx = cq.x, cyy = cq.y;
  const float cxy = alg1::quant(conic[3 * e + 1], coord_prec);
  const bool sp = spiky[e] != 0;

  uint32_t words[4] = {0u, 0u, 0u, 0u};
  if (s_on_lattice) {
    // Column i's x from top leader i, row i's y from top leader 4 i.
    float tx[kLattice], ty[kLattice], bx[kLattice], by[kLattice];
#pragma unroll
    for (int i = 0; i < kLattice; ++i) {
      const float2 top = alg1::quant2(ox + s_top[2 * i],
                                      oy + s_top[2 * kLattice * i + 1],
                                      coord_prec);
      const float2 bot = alg1::quant2(ox + s_bot[2 * i],
                                      oy + s_bot[2 * kLattice * i + 1],
                                      coord_prec);
      tx[i] = top.x;
      ty[i] = top.y;
      bx[i] = bot.x;
      by[i] = bot.y;
    }
    hits_on_lattice<kMul, kAcc>(tx, ty, bx, by, mq.x, mq.y, cxx, cxy, cyy,
                                l, sp, mode, delta_prec, k_slack, words);
  } else {
#pragma unroll 4
    for (int j = 0; j < kMiniTiles; ++j) {
      const float2 top = alg1::quant2(ox + s_top[2 * j],
                                      oy + s_top[2 * j + 1], coord_prec);
      const float2 bot = alg1::quant2(ox + s_bot[2 * j],
                                      oy + s_bot[2 * j + 1], coord_prec);
      const bool hit = alg1::hit(top.x, top.y, bot.x, bot.y, mq.x, mq.y,
                                 cxx, cxy, cyy, l, sp, mode, delta_prec,
                                 kMul, kAcc, k_slack);
      words[j >> 2] |= static_cast<uint32_t>(hit) << (8 * (j & 3));
    }
  }
  out[e] = make_uint4(words[0], words[1], words[2], words[3]);
}

using EntryKernel = void (*)(const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const int8_t*, uint4*, int, int, int, int, int,
                            float);

// The instance for (mul_prec, acc_prec), indexed 3 * mul_prec + acc_prec.
const EntryKernel kEntryKernels[9] = {
    prtu_entry_kernel<0, 0>, prtu_entry_kernel<0, 1>, prtu_entry_kernel<0, 2>,
    prtu_entry_kernel<1, 0>, prtu_entry_kernel<1, 1>, prtu_entry_kernel<1, 2>,
    prtu_entry_kernel<2, 0>, prtu_entry_kernel<2, 1>, prtu_entry_kernel<2, 2>};

__global__ void quant_kernel(const float* __restrict__ in,
                             float* __restrict__ out, long long n, int kind,
                             int paired) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (paired) {
    if (2 * i + 1 < n) {
      const float2 q = alg1::quant2(in[2 * i], in[2 * i + 1], kind);
      out[2 * i] = q.x;
      out[2 * i + 1] = q.y;
    }
  } else if (i < n) {
    out[i] = alg1::quant(in[i], kind);
  }
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
  if (mul_prec < 0 || mul_prec > 2 || acc_prec < 0 || acc_prec > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const EntryKernel kernel = kEntryKernels[3 * mul_prec + acc_prec];
  const int blocks = (n_entries + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p_top), static_cast<const float*>(p_bot),
      static_cast<const float*>(origins), static_cast<const float*>(mu),
      static_cast<const float*>(conic), static_cast<const float*>(lhs),
      static_cast<const int8_t*>(spiky), static_cast<uint4*>(out),
      n_entries, k_per_tile, mode, coord_prec, delta_prec, k_slack);
  return static_cast<int>(cudaGetLastError());
}

// Test hook: out = alg1::quant(in, kind) elementwise (paired = 0), or
// alg1::quant2 over consecutive pairs (paired = 1, n even). Returns the
// launch's cudaError_t.
extern "C" int alg1_quant_launch(const void* in, void* out, long long n,
                                 int kind, int paired, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long items = paired ? n / 2 : n;
  const long long blocks = (items + threads - 1) / threads;
  quant_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), n, kind,
      paired);
  return static_cast<int>(cudaGetLastError());
}
