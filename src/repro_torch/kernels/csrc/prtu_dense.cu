// Dense Mini-Tile CAT (the dense-mask oracle's CTU) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/prtu.py::prtu_cat_mask (body
// `_prtu_kernel` / `_alg1_hits`): for every (mini-tile m, Gaussian g) pair
// of the frame it evaluates Alg. 1's four corner weights of g on m's pixel
// rectangle and writes one int8 hit flag, into a row-major (M, N) mask.
//
// What bounds it: the bytes of the mask it writes, then the pairs it
// must evaluate. At 1024x1024 with 131072 Gaussians the mask is 8.6 GB
// (2.57 ms at 3.35 TB/s) and must be written whole, while the pairs that
// can hit are a fifth of M * N under MIXED. The design evaluates only the
// pairs that can hit, each with as few instructions as its rounding
// allows, and writes every byte once, in 16-byte stores:
//   * a block owns one region of kSide x kSide mini-tiles (kRows mask rows
//     of an image of `width` mini-tiles a row) and kCols consecutive
//     Gaussian columns, and stages that (kRows, kCols) tile of flags in
//     shared memory: zeroed, filled by the pairs it evaluates, then
//     written out row by row with 16-byte streaming stores (a warp writes
//     512 contiguous bytes of one mask row). No memset runs before it;
//   * column compaction: a Gaussian whose lhs is not above -inf (culled, or
//     NaN) never hits, so only the live columns enter the block's list
//     (ballot and a shared counter), one thread each; their zero flags
//     come from the zeroed tile, and a block with an empty list writes
//     zeros straight from registers;
//   * the fp8-overflow skip, only under a fp8 delta: a delta with
//     !(|d| <= 464) rounds to NaN there (alg1.cuh, fault F1), and a pair
//     whose two x deltas, or two y deltas, are NaN has four NaN corner
//     weights and never hits. A column leaves the list when every distinct
//     x of the region, or every distinct y, gives such a pair of deltas;
//     the test is computed from those deltas themselves (fp32 subtraction
//     of the coordinate-quantized values), so NaN coordinates (FULL_FP8
//     above 464 px) are far as well. Under fp32 and fp16 deltas the skip
//     does not exist: pairs beyond 464 px can hit there;
//   * the separable half hoisted: the region's leaders lie on a lattice (x
//     fixed down each column of the region, y along each row), so a column
//     has kSide distinct (top, bottom) x deltas and separable terms, held
//     in registers, and kSide distinct y pairs, one per region row; only
//     the cross terms, the corner sums and the decision remain per pair.
//     The lattice is checked, not assumed: the staged leaders are compared
//     bit for bit, and off the lattice (or with a `width` that does not
//     describe the rows) the block runs alg1::hit per pair, which is
//     exact, and skips nothing but dead columns;
//   * float16 arithmetic where it is exact (region_hits_half): when the
//     coordinates, deltas, products and sums all round to fp16 or fp8, as
//     under MIXED, each step runs as one paired half-precision operation,
//     and the decision lhs > E (1 - slack) becomes E < T for a float16
//     threshold T per column, two corners a compare;
//   * the delta, multiplier and adder precisions are template parameters
//     (27 instances in one table, one launch site), so no per-pair rounding
//     step branches; the coordinate precision is applied once per staged
//     leader and once per column, at run time.
// The TPU kernel's (128, 128) VMEM blocks and padding to block multiples do
// not carry over: the grid covers the ragged edges and masks them.
// -Xptxas -v for sm_90a (printed by kernels/build.py at build time): 80
// registers, 34,828 bytes of static shared memory, no spills (the MIXED
// instance and FULL_FP32's alike): six blocks fit an SM.
//
// Indexing: M * N reaches 8.6e9 at 1024x1024 with 131072 Gaussians, past
// int32, so every output offset is computed in 64 bits (the wrapper checks
// M and N each fit in int32, and the grid's two dimensions).
//
// Numerics: Alg. 1 of alg1.cuh, one rounding per step, built with
// -fmad=false, shared with the entry-stream kernel prtu_entry.cu: a dense
// mask gathered at a compacted entry equals that kernel's bit.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "alg1.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSide = 8;                // region side, in mini-tiles
constexpr int kRows = kSide * kSide;    // mask rows per block
constexpr int kCols = 512;              // Gaussian columns per block
constexpr int kColsPerThread = kCols / kThreads;
constexpr int kChunks = kCols / 16;     // 16-byte pieces of a tile row

struct Geometry {
  int m_rows, n_cols;
  int width;      // mini-tiles per image row (the mask rows' layout)
  int height;     // image rows of mini-tiles, ceil(m_rows / width)
  int regions_x;  // ceil(width / kSide)
};

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// Whether a delta rounds to NaN under a fp8 delta (alg1::quant2, kind 2).
__device__ __forceinline__ bool fp8_nan(float d) {
  return !(fabsf(d) <= alg1::kFp8Overflow);
}

// alg1::decide with the sampling mode resolved per column: the sparse
// decision uses the main diagonal (E0, E3); the dense one adds E1, E2.
__device__ __forceinline__ bool uses_dense(int mode, bool spiky) {
  switch (mode) {
    case 0: return true;
    case 1: return false;
    case 2: return !spiky;
    default: return spiky;
  }
}

// Whether a corner weight passes: lhs > E * (1 - slack). With no slack
// (kUnit) the product is E itself, bit for bit, and is not computed.
template <bool kUnit>
__device__ __forceinline__ bool passes(float l, float e, float k_slack) {
  return kUnit ? l > e : l > e * k_slack;
}

// The flags of one Gaussian column over an on-lattice region: row
// kSide * i + j has its top leader at (lead[j].x, lead[kSide i].y) and its
// bottom leader at (lead[j].z, lead[kSide i].w), coordinate-quantized.
template <int kDelta, int kMul, int kAcc, bool kUnit>
__device__ __forceinline__ void region_hits(
    const float4* __restrict__ lead, float mu_x, float mu_y, float cxx,
    float cxy, float cyy, float l, bool dense, float k_slack,
    uint8_t* __restrict__ col) {
  float2 dx[kSide], sx[kSide];  // (top, bottom) x deltas and their terms
#pragma unroll
  for (int j = 0; j < kSide; ++j) {
    const float4 a = lead[j];
    dx[j] = alg1::delta2(a.x, a.z, mu_x, mu_x, kDelta);
    sx[j] = alg1::separable2(dx[j], cxx, cxx, kMul);
  }
#pragma unroll 1
  for (int i = 0; i < kSide; ++i) {
    const float4 a = lead[kSide * i];
    const float2 dy = alg1::delta2(a.y, a.w, mu_y, mu_y, kDelta);
    const float2 sy = alg1::separable2(dy, cyy, cyy, kMul);
#pragma unroll
    for (int j = 0; j < kSide; ++j) {
      const float2 t01 =
          alg1::cross2(dx[j], make_float2(dy.x, dy.x), cxy, kMul);
      const float2 t23 =
          alg1::cross2(dx[j], make_float2(dy.y, dy.y), cxy, kMul);
      const float2 e01 =
          alg1::corner2(sx[j], make_float2(sy.x, sy.x), t01, kAcc);
      const float2 e23 =
          alg1::corner2(sx[j], make_float2(sy.y, sy.y), t23, kAcc);
      const bool h0 = passes<kUnit>(l, e01.x, k_slack);
      const bool h1 = passes<kUnit>(l, e01.y, k_slack);
      const bool h2 = passes<kUnit>(l, e23.x, k_slack);
      const bool h3 = passes<kUnit>(l, e23.y, k_slack);
      col[(kSide * i + j) * kCols] =
          static_cast<uint8_t>(h0 || h3 || (dense && (h1 || h2)));
    }
  }
}

// The float16 threshold of one column's decision. For k > 0 the fp32
// product fl(E * k) never decreases as E grows, so the float16 weights E
// that pass (lhs > fl(E * k)) are exactly those below the smallest one
// that does not: E passes iff E < T (NaN never does). T is found among the
// float16 values in order, -inf (index 0) to +inf (which never passes:
// lhs > inf is false), by walking from the float16 nearest lhs / k: down
// while the value below does not pass, up while this one does. -0 and +0
// pass alike, so T is never +0 with -0 passing.
__device__ __forceinline__ __half pass_threshold(float l, float k) {
  constexpr int kNeg = 0x7c00;    // ordered index of -0; +0 is kNeg + 1
  constexpr int kTop = 2 * kNeg + 1;  // +inf
  auto value = [](int o) {
    return __ushort_as_half(o <= kNeg
        ? static_cast<unsigned short>(0x8000 | (kNeg - o))
        : static_cast<unsigned short>(o - kNeg - 1));
  };
  auto passes = [&](int o) { return l > __half2float(value(o)) * k; };
  const unsigned short b = __half_as_ushort(__float2half_rn(l / k));
  int o = (b & 0x8000) ? kNeg - (b & 0x7fff) : b + kNeg + 1;
  o = min(max(o, 0), kTop);
  while (o > 0 && !passes(o - 1)) --o;
  while (passes(o)) ++o;
  return value(o);
}

// alg1::delta2's rounding of (a - mu, b - mu) at a fp16 (kDelta 1) or fp8
// (kDelta 2) delta, as float16 values.
template <int kDelta>
__device__ __forceinline__ __half2 delta_h2(float a, float b, float mu) {
  return kDelta == 2 ? alg1::fp8_quant_h2(a - mu, b - mu)
                     : __floats2half2_rn(a - mu, b - mu);
}

// alg1::separable2 at fp16 products, q(q(0.5 q(d d)) c), on float16 d and
// c: each product of two float16 values is exact in fp32, so one float16
// product rounds as the fp32 product rounded to fp16.
__device__ __forceinline__ __half2 separable_h2(__half2 d, __half2 c) {
  const __half2 sq = __hmul2_rn(d, d);
  return __hmul2_rn(__hmul2_rn(sq, __float2half2_rn(0.5f)), c);
}

// region_hits when every operand of Alg. 1's steps is a float16 value:
// coordinates rounded to fp16 or fp8 (e4m3 values are float16 values),
// deltas to fp16 or fp8, products and sums to fp16 (mul_prec = acc_prec =
// fp16, as under MIXED). Then each step's fp32 operation followed by one
// rounding to fp16 equals the float16 operation on the card, bit for bit:
// a product of two float16 values is exact in fp32, and a sum rounded
// first to fp32 and then to fp16 rounds as the sum rounded once, since
// fp32 carries 24 >= 2 * 11 + 2 bits. So the deltas come out of the
// conversion as float16, every product and sum is a paired half-precision
// operation (__hmul2_rn keeps a product from contracting into a sum), and
// the decision compares the corner weights with the column's threshold
// (pass_threshold, k = 1 - slack > 0), two corners a compare.
template <int kDelta>
__device__ __forceinline__ void region_hits_half(
    const float4* __restrict__ lead, float mu_x, float mu_y, float cxx,
    float cxy, float cyy, __half2 thresh, bool dense,
    uint8_t* __restrict__ col) {
  const __half2 cx = __float2half2_rn(cxx), cy = __float2half2_rn(cyy);
  const __half2 c = __float2half2_rn(cxy);
  __half2 dx[kSide], sx[kSide];  // (top, bottom) x deltas and their terms
#pragma unroll
  for (int j = 0; j < kSide; ++j) {
    const float4 a = lead[j];
    dx[j] = delta_h2<kDelta>(a.x, a.z, mu_x);
    sx[j] = separable_h2(dx[j], cx);
  }
  // A pass mask holds 0xffff in each half whose corner passes; with
  // the other pair's halves swapped, the low half ORs the main diagonal
  // (E0, E3), which always counts, and the high half the other corners
  // (E1, E2), which count where the column samples densely.
  const uint32_t counted = dense ? 0xffffffffu : 0x0000ffffu;
#pragma unroll 1
  for (int i = 0; i < kSide; ++i) {
    const float4 a = lead[kSide * i];
    const __half2 dy = delta_h2<kDelta>(a.y, a.w, mu_y);
    const __half2 sy = separable_h2(dy, cy);
    const __half2 dt = __low2half2(dy), db = __high2half2(dy);
    const __half2 st = __low2half2(sy), sb = __high2half2(sy);
#pragma unroll
    for (int j = 0; j < kSide; ++j) {
      const __half2 t01 = __hmul2_rn(__hmul2_rn(dx[j], dt), c);
      const __half2 t23 = __hmul2_rn(__hmul2_rn(dx[j], db), c);
      const __half2 e01 = __hadd2_rn(__hadd2_rn(sx[j], st), t01);
      const __half2 e23 = __hadd2_rn(__hadd2_rn(sx[j], sb), t23);
      const uint32_t p01 = __hlt2_mask(e01, thresh);        // E0, E1
      const uint32_t p23 = __hlt2_mask(e23, thresh);        // E2, E3
      const uint32_t any = (p01 | __byte_perm(p23, 0, 0x1032)) & counted;
      col[(kSide * i + j) * kCols] = static_cast<uint8_t>(min(any, 1u));
    }
  }
}

// One column over an on-lattice region: the float16 form where every
// operand is a float16 value (coord_prec fp16 or fp8) and k = 1 - slack
// > 0, else region_hits, without the slack product when there is no slack
// (FULL_FP32's case: 4% faster there on the H100).
template <int kDelta, int kMul, int kAcc>
__device__ __forceinline__ void column_hits(
    const float4* __restrict__ lead, int coord_prec, float mu_x, float mu_y,
    float cxx, float cxy, float cyy, float l, bool dense, float k_slack,
    uint8_t* __restrict__ col) {
  constexpr bool kHalf = kMul == 1 && kAcc == 1 && kDelta != 0;
  if (kHalf && coord_prec != 0 && k_slack > 0.f) {
    region_hits_half<kDelta>(lead, mu_x, mu_y, cxx, cxy, cyy,
                             __half2half2(pass_threshold(l, k_slack)),
                             dense, col);
  } else if (k_slack == 1.f) {
    region_hits<kDelta, kMul, kAcc, true>(lead, mu_x, mu_y, cxx, cxy, cyy,
                                          l, dense, k_slack, col);
  } else {
    region_hits<kDelta, kMul, kAcc, false>(lead, mu_x, mu_y, cxx, cxy, cyy,
                                           l, dense, k_slack, col);
  }
}

// Sampling modes: 0 uniform_dense, 1 uniform_sparse, 2 smooth_focused,
// 3 spiky_focused.
template <int kDelta, int kMul, int kAcc>
__global__ void __launch_bounds__(kThreads) prtu_dense_kernel(
    const float* __restrict__ p_top,   // (M, 2) image-space leader coords
    const float* __restrict__ p_bot,   // (M, 2)
    const float* __restrict__ mu,      // (N, 2)
    const float* __restrict__ conic,   // (N, 3)
    const float* __restrict__ lhs,     // (N,) ln(255 o), -inf if culled
    const int8_t* __restrict__ spiky,  // (N,)
    int8_t* __restrict__ out,          // (M, N)
    Geometry geo, int mode, int coord_prec, float k_slack) {
  __shared__ __align__(16) uint8_t s_flags[kRows][kCols];
  __shared__ float4 s_lead[kRows];     // quantized ptx, pty, pbx, pby
  __shared__ uint16_t s_items[kCols];  // the columns to evaluate
  __shared__ uint32_t s_valid[2];      // rows inside the mask, 64 bits
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int x0 = kSide * (blockIdx.x % geo.regions_x);
  const int y0 = kSide * (blockIdx.x / geo.regions_x);
  const long long c0 = static_cast<long long>(blockIdx.y) * kCols;
  const int n_here = static_cast<int>(
      min(static_cast<long long>(kCols), geo.n_cols - c0));
  // Mask row of region row r = kSide * i + j (64-bit: y * width may pass
  // int32 on a ragged last region).
  auto row_of = [&](int r) {
    return static_cast<long long>(y0 + r / kSide) * geo.width + x0 +
           r % kSide;
  };

  if (tid == 0) s_count = 0;
  if (tid < kRows) {
    const bool valid = x0 + tid % kSide < geo.width &&
                       y0 + tid / kSide < geo.height &&
                       row_of(tid) < geo.m_rows;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) {
      const long long m = row_of(tid);
      const float2 t = reinterpret_cast<const float2*>(p_top)[m];
      const float2 b = reinterpret_cast<const float2*>(p_bot)[m];
      const float2 tq = alg1::quant2(t.x, t.y, coord_prec);
      const float2 bq = alg1::quant2(b.x, b.y, coord_prec);
      q = make_float4(tq.x, tq.y, bq.x, bq.y);
    }
    s_lead[tid] = q;
    const uint32_t bits = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) s_valid[tid >> 5] = bits;
  }
  __syncthreads();
  const unsigned long long valid_rows =
      (static_cast<unsigned long long>(s_valid[1]) << 32) | s_valid[0];
  auto row_valid = [&](int r) { return ((valid_rows >> r) & 1ull) != 0; };

  // The lattice: every row's x equals its region column's in row 0, its y
  // its region row's in column 0, bit for bit, top and bottom. A valid row
  // (i, j) implies valid rows (0, j) and (i, 0).
  bool ok = true;
  if (tid < kRows && row_valid(tid)) {
    const float4 q = s_lead[tid];
    const float4 cx = s_lead[tid % kSide];
    const float4 cy = s_lead[tid - tid % kSide];
    ok = same_bits(q.x, cx.x) && same_bits(q.z, cx.z) &&
         same_bits(q.y, cy.y) && same_bits(q.w, cy.w);
  }
  const bool lattice = __syncthreads_and(ok) != 0;

  // Column compaction: live columns, less those the fp8 skip drops. The
  // skip reads the region's distinct leader coordinates from registers.
  constexpr bool kSkip = kDelta == 2;
  float tx[kSide], bx[kSide], ty[kSide], by[kSide];
  uint32_t valid_x = 0u, valid_y = 0u;  // region columns j, rows i inside
  if (kSkip && lattice) {
#pragma unroll
    for (int k = 0; k < kSide; ++k) {
      const float4 a = s_lead[k];
      const float4 b = s_lead[kSide * k];
      tx[k] = a.x;
      bx[k] = a.z;
      ty[k] = b.y;
      by[k] = b.w;
      valid_x |= static_cast<uint32_t>(row_valid(k)) << k;
      valid_y |= static_cast<uint32_t>(row_valid(kSide * k)) << k;
    }
  }
#pragma unroll
  for (int s = 0; s < kColsPerThread; ++s) {
    const int c = s * kThreads + tid;
    bool keep = false;
    if (c < n_here) {
      const long long g = c0 + c;
      keep = lhs[g] > __uint_as_float(0xff800000u);  // -inf, NaN never hit
      if (kSkip && keep && lattice) {
        const float2 mg = reinterpret_cast<const float2*>(mu)[g];
        const float2 mq = alg1::quant2(mg.x, mg.y, coord_prec);
        bool far_x = true, far_y = true;
#pragma unroll
        for (int k = 0; k < kSide; ++k) {
          if ((valid_x >> k) & 1u)
            far_x = far_x && fp8_nan(tx[k] - mq.x) && fp8_nan(bx[k] - mq.x);
          if ((valid_y >> k) & 1u)
            far_y = far_y && fp8_nan(ty[k] - mq.y) && fp8_nan(by[k] - mq.y);
        }
        keep = !(far_x || far_y);
      }
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, keep);
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&s_count, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (keep)
      s_items[base + __popc(ballot & ((1u << lane) - 1u))] =
          static_cast<uint16_t>(c);
  }
  __syncthreads();
  const int n_items = s_count;

  if (n_items > 0) {
    uint4* tile = reinterpret_cast<uint4*>(&s_flags[0][0]);
    for (int k = tid; k < kRows * kChunks; k += kThreads)
      tile[k] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    for (int it = tid; it < n_items; it += kThreads) {
      const int c = s_items[it];
      const long long g = c0 + c;
      const float2 mg = reinterpret_cast<const float2*>(mu)[g];
      const float2 mq = alg1::quant2(mg.x, mg.y, coord_prec);
      const float2 cq = alg1::quant2(conic[3 * g], conic[3 * g + 2],
                                     coord_prec);
      const float cxy = alg1::quant(conic[3 * g + 1], coord_prec);
      const float l = lhs[g];
      const bool sp = spiky[g] != 0;
      uint8_t* col = &s_flags[0][c];
      if (lattice) {
        column_hits<kDelta, kMul, kAcc>(s_lead, coord_prec, mq.x, mq.y, cq.x,
                                        cxy, cq.y, l, uses_dense(mode, sp),
                                        k_slack, col);
      } else {
        for (int r = 0; r < kRows; ++r) {
          if (!row_valid(r)) continue;
          const float4 a = s_lead[r];
          col[r * kCols] = static_cast<uint8_t>(alg1::hit(
              a.x, a.y, a.z, a.w, mq.x, mq.y, cq.x, cxy, cq.y, l, sp, mode,
              kDelta, kMul, kAcc, k_slack));
        }
      }
    }
    __syncthreads();
  }

  // Write the tile: each valid row's n_here bytes, in 16-byte pieces when
  // every row starts on a 16-byte boundary (N % 16 == 0), else bytewise.
  if ((geo.n_cols & 15) == 0) {
    for (int k = tid; k < kRows * kChunks; k += kThreads) {
      const int r = k / kChunks, p = k % kChunks;
      if (16 * p >= n_here || !row_valid(r)) continue;
      const uint4 v = n_items > 0
          ? *reinterpret_cast<const uint4*>(&s_flags[r][16 * p])
          : make_uint4(0u, 0u, 0u, 0u);
      __stcs(reinterpret_cast<int4*>(out + row_of(r) * geo.n_cols + c0 +
                                     16 * p),
             make_int4(static_cast<int>(v.x), static_cast<int>(v.y),
                       static_cast<int>(v.z), static_cast<int>(v.w)));
    }
  } else {
    for (int k = tid; k < kRows * kCols; k += kThreads) {
      const int r = k / kCols, c = k % kCols;
      if (c >= n_here || !row_valid(r)) continue;
      out[row_of(r) * geo.n_cols + c0 + c] =
          n_items > 0 ? static_cast<int8_t>(s_flags[r][c]) : int8_t{0};
    }
  }
}

using DenseKernel = void (*)(const float*, const float*, const float*,
                             const float*, const float*, const int8_t*,
                             int8_t*, Geometry, int, int, float);

// The instance for (delta_prec, mul_prec, acc_prec), indexed
// 9 * delta_prec + 3 * mul_prec + acc_prec.
#define PRTU_DENSE_ROW(d, m)                                         \
  prtu_dense_kernel<d, m, 0>, prtu_dense_kernel<d, m, 1>,            \
      prtu_dense_kernel<d, m, 2>
const DenseKernel kDenseKernels[27] = {
    PRTU_DENSE_ROW(0, 0), PRTU_DENSE_ROW(0, 1), PRTU_DENSE_ROW(0, 2),
    PRTU_DENSE_ROW(1, 0), PRTU_DENSE_ROW(1, 1), PRTU_DENSE_ROW(1, 2),
    PRTU_DENSE_ROW(2, 0), PRTU_DENSE_ROW(2, 1), PRTU_DENSE_ROW(2, 2)};
#undef PRTU_DENSE_ROW

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers of
// contiguous tensors; `width` is the number of mini-tiles in an image row
// of the mask's row layout (rows row-major over the image); `stream` is
// the caller's cudaStream_t. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int prtu_cat_mask_launch(
    const void* p_top, const void* p_bot, const void* mu, const void* conic,
    const void* lhs, const void* spiky, void* out, int m_rows, int n_cols,
    int width, int mode, int coord_prec, int delta_prec, int mul_prec,
    int acc_prec, float k_slack, void* stream) {
  if (m_rows == 0 || n_cols == 0) return 0;
  if (width <= 0 || delta_prec < 0 || delta_prec > 2 || mul_prec < 0 ||
      mul_prec > 2 || acc_prec < 0 || acc_prec > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry geo;
  geo.m_rows = m_rows;
  geo.n_cols = n_cols;
  geo.width = width;
  geo.height = static_cast<int>((static_cast<long long>(m_rows) + width - 1)
                                / width);
  geo.regions_x = (width + kSide - 1) / kSide;
  const long long regions = static_cast<long long>(geo.regions_x) *
                            ((geo.height + kSide - 1) / kSide);
  const long long col_blocks = (static_cast<long long>(n_cols) + kCols - 1)
                               / kCols;
  if (regions > 0x7fffffffLL || col_blocks > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const DenseKernel kernel =
      kDenseKernels[9 * delta_prec + 3 * mul_prec + acc_prec];
  const dim3 grid(static_cast<unsigned>(regions),
                  static_cast<unsigned>(col_blocks));
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p_top), static_cast<const float*>(p_bot),
      static_cast<const float*>(mu), static_cast<const float*>(conic),
      static_cast<const float*>(lhs), static_cast<const int8_t*>(spiky),
      static_cast<int8_t*>(out), geo, mode, coord_prec, k_slack);
  return static_cast<int>(cudaGetLastError());
}
