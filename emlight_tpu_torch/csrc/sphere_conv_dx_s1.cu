// Sphere conv input gradient (dx) at stride 1 — hand-written CUDA C++ for
// sm_90a (H100).
//
// Replaces emlight_tpu/nn/sphere_conv_vjp.py::_dx_kernel_s1_umajor (the
// Pallas TPU kernel B3, launched by _dx_pallas), which the port routes the
// stride-1 maps of at least UMAJOR_MIN_PIXELS (nn/sphere_conv_kernel.py) to.
// The forward reads
//
//   out[i, j] += w(i,t,k,j) * x[rows[i,t,k], (j + s[i,t,k]) mod W] @ K_t
//
// and its transpose, for the cotangent g (B, H, W, Cout), regrouped by tap
// (U = g K_t^T is linear in g, so no U is formed):
//
//   dx[r, col, :] = sum_t G_t[r, col, :] @ K_t^T
//   G_t[r, col, o] = sum over the slots m of (r, t) of
//                    w_m(col) * g[out_row_m, (col - shift_m) mod W, o]
//   w_m(col)      = 0 if (col - shift_m) mod W == jdev_m else w0_m
//
// The slots of each (input row, tap) are the port's tap_grouped_tables
// (nn/sphere_conv_vjp.py): the slots of inverse_tables, grouped by tap in
// their order there, packed as int4 (out_row, shift, jdev, w0 bits), with a
// count per (row, tap) (at most 8 at the model's maps); their output rows
// lie in [r + dmin, r + dmax] ([r - 1, r + 2] at the model's maps).
//
// What bounds it on an H100: operations, 2*9*Cin*Cout flops per input
// pixel, as the forward. The TPU kernel and this port's earlier kernel
// formed U (B, 9, H, W, Cin) and gathered it; on the card that U went
// through device memory (604 MB at 128x256, Cin 64) and its product ran on
// the CUDA cores.
//
// What this design does about it: B1's structure with g in place of x. An
// implicit GEMM on the tensor cores with mma.sync, M = the B*H*W flat input
// pixels (64 per block), N = Cin (BN = 32..256 per block, as wide as Cin
// allows), K = Cout slabs of 64 bytes (16 f32 or 32 bf16 channels) x 9
// taps, slab-major. One block of 16 warps per SM, warp-specialised:
// - Warps 8-15 produce, in two groups of 4 that take alternate K steps.
//   Per slab all of them bring the g rows the block's slots read (every
//   column: the circular shifts reach any) into shared memory, by cp.async
//   in 16-byte chunks rotated across banks (by plain loads where Cout is
//   not a multiple of the chunk: Cout = 3 rows are 12 bytes), one buffer
//   filling while the 9 taps of the other are combined. Where two buffers
//   of those rows do not fit in shared memory (W above 256: a 256x512 map
//   from --crop_size 512), nothing is staged and each slot's chunk is read
//   from device memory (L2) where it is combined. Per K step (slab,
//   tap) a lane takes one 16-byte chunk of channels at two pixels and sums
//   the pixel's slots of (row, tap) over it (whole-chunk reads; the dead
//   column skipped, not multiplied: 0 * inf would poison dx); a 4 x 4
//   transpose among the 4 lanes of a pixel (shuffles) leaves each lane the
//   values its mma fragments hold, which go to a ring of 4 A tiles in a
//   fragment-native layout (a lane's words of a fragment in one 16-byte
//   slot), split into hi and lo: f32 into TF32 hi and lo, bf16 into bf16 hi
//   (rounded to nearest) and lo, the bf16 of the rest, so the product sees
//   Ĝ to about 2^-16 where one bf16 would round it to 2^-8 (the reference
//   keeps U in f32).
// - Warps 0-7 consume: per K step they bring the block's B tile of the
//   next step into shared memory by cp.async (K_t^T pre-tiled once per
//   call by dx_s1_kprep_kernel as the lanes' fragments, f32 split into
//   TF32 hi and lo), wait for the A tile on its named barrier, and run
//   mma.sync: f32 in 3xTF32 (v = hi + lo, hi cut to TF32, lo the exact
//   rest; lo*hi + hi*lo + hi*hi), bf16 as Ĝ lo x K + Ĝ hi x K (K is bf16
//   already, so exact), each 16-deep step (8-deep for f32 at BN = 256,
//   which has no registers for more) summed from zero on the tensor cores
//   and added in f32 on the CUDA cores (their chained f32 accumulation does
//   not round to nearest).
// mma.sync and not wgmma for both dtypes: its fragments are plain register
// loads, so the combined operand needs no core-matrix layout and ragged
// edges (Cout, Cin and pixels off the tile) are masked where they are read.
// Every dx value is summed in one block in a fixed order: the same from run
// to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 256;  // warps 0-7: mma, 2 along M x 4 along N
constexpr int GROUP = 128;      // a producer group: 4 warps
constexpr int NTHREADS = CONSUMERS + 2 * GROUP;
constexpr int BM = 64;          // flat input pixels per block
constexpr int MT = BM / 16;     // m16 tiles per block
constexpr int NST = 4;          // A tiles in the ring
// named barriers (0 is __syncthreads): a slot full, a slot empty, all producers
constexpr int BAR_FULL = 1, BAR_EMPTY = BAR_FULL + NST, BAR_PROD = BAR_EMPTY + NST,
              BAR_CONS = BAR_PROD + 1;
constexpr int PX_BYTES = 64;   // a staged pixel: one Cout slab, 16 f32 or 32 bf16
constexpr int PREP_THREADS = 256;
constexpr int SLOT_BATCH = 8;  // slots of a (row, tap) whose reads issue together
constexpr int SMEM_MAX = 232448;

// The mma fragments, per dtype: A is m16 x k, row-major (pixels, K), a
// lane's values of one in A_WORDS words (the producers' transpose puts
// them there); B is k x n8 (K, input channels), B_VALS values of a lane in
// B_WORDS words, value v at K b_k.
template <typename T>
struct Frag;

template <>
struct Frag<float> {
  static constexpr int KSTEP = 8;
  static constexpr int A_WORDS = 8;              // a0..a3 as TF32 hi, then lo
  static constexpr int B_VALS = 2, B_WORDS = 4;  // b0, b1 hi, then b0, b1 lo
  static __device__ __forceinline__ int b_k(int lane, int v) { return (lane & 3) + 4 * v; }
  static __device__ __forceinline__ float load(float v) { return v; }
};

template <>
struct Frag<__nv_bfloat16> {
  static constexpr int KSTEP = 16;
  static constexpr int A_WORDS = 8;              // hi, then lo; register r: values 2r, 2r+1
  static constexpr int B_VALS = 4, B_WORDS = 2;
  static __device__ __forceinline__ int b_k(int lane, int v) {
    return 2 * (lane & 3) + 8 * (v >> 1) + (v & 1);
  }
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
};

constexpr uint32_t TF32_MASK = 0xffffe000u;  // sign, exponent and TF32's 10 mantissa bits

// 3xTF32's split of v: hi = v cut to TF32's 10 mantissa bits, lo = v - hi
// (exact in f32); the tensor cores read a TF32 operand's top 19 bits, so lo
// needs no rounding either: two instructions where rounding takes more
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & TF32_MASK;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h2);
}

// values -> the lane's words of a fragment: f32 as TF32 hi words then lo
// words, bf16 as packed pairs (rounded to nearest)
template <bool F32, int NV>
__device__ __forceinline__ void pack_words(const float (&v)[NV], uint32_t* w) {
  if constexpr (F32) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      split_tf32(v[i], w[i], w[NV + i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) w[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
struct Layout {
  using F = Frag<T>;
  static constexpr int OS = PX_BYTES / (int)sizeof(T);  // Cout channels per slab
  static constexpr int VEC = 16 / (int)sizeof(T);       // channels per 16-byte chunk
  static constexpr int SUB = OS / F::KSTEP;             // mma steps per K step: 2
  static constexpr int A_FR = SUB * MT * 32;            // lane fragments of A per K step
  static constexpr int A_STAGE = A_FR * F::A_WORDS;     // words
  // a group's lane (m16 tile: its warp) stages both mma steps of its fragment
  static_assert(SUB == 2 && A_FR == 2 * GROUP, "the A tile divides over a group");
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// 16 bytes of g unpacked to f32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// 4 x 4 transpose among lanes 4 g .. 4 g + 3 (c = lane % 4): lane c holds
// row c, M[c][0..3], and leaves with column c, M[0..3][c]
__device__ __forceinline__ void transpose4(uint32_t (&m)[4], int c) {
  const bool odd = c & 1;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? m[0] : m[1], 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? m[2] : m[3], 1);
  // rows c & ~1 and (c & ~1) + 1, columns c & 1 and 2 + (c & 1)
  const uint32_t b0 = odd ? r0 : m[0], b1 = odd ? m[1] : r0;
  const uint32_t b2 = odd ? r1 : m[2], b3 = odd ? m[3] : r1;
  const bool hi = c & 2;
  const uint32_t q0 = __shfl_xor_sync(0xffffffffu, hi ? b0 : b2, 2);
  const uint32_t q1 = __shfl_xor_sync(0xffffffffu, hi ? b1 : b3, 2);
  m[0] = hi ? q0 : b0;
  m[1] = hi ? q1 : b1;
  m[2] = hi ? b2 : q0;
  m[3] = hi ? b3 : q1;
}

// the 16-byte slot of chunk q of staged pixel px: rotated by px / 2, so the
// 8 pixels a quarter warp reads fall on distinct banks
__device__ __forceinline__ int row_slot(int px, int q) { return (q + (px >> 1)) & 3; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// K^T for the main kernel: the lane fragments of K step s (Cout slab s / 9,
// tap s % 9), n8 tile nt (input channels [8 nt, +8)), mma step sub at
// ((s * n_tiles + nt) * SUB + sub) * 32 + lane, each B_WORDS words; 0 past
// Cout and Cin.
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
dx_s1_kprep_kernel(const T* __restrict__ kmat, uint32_t* __restrict__ ktiles, int Cin, int Cout,
                   long long n_frags) {
  using F = Frag<T>;
  using L = Layout<T>;
  constexpr bool F32 = sizeof(T) == 4;
  const int n_tiles = (Cin + 7) / 8;
  for (long long f = (long long)blockIdx.x * PREP_THREADS + threadIdx.x; f < n_frags;
       f += (long long)gridDim.x * PREP_THREADS) {
    const int lane = (int)(f & 31);
    const long long rest = f >> 5;
    const int sub = (int)(rest % L::SUB);
    const int nt = (int)((rest / L::SUB) % n_tiles);
    const int s = (int)(rest / L::SUB / n_tiles);
    const int t = s % 9;
    const int c = nt * 8 + (lane >> 2);
    float v[F::B_VALS];
#pragma unroll
    for (int e = 0; e < F::B_VALS; ++e) {
      const int o = (s / 9) * L::OS + sub * F::KSTEP + F::b_k(lane, e);
      v[e] = (o < Cout && c < Cin) ? F::load(kmat[((size_t)t * Cin + c) * Cout + o]) : 0.f;
    }
    uint32_t w[F::B_WORDS];
    pack_words<F32, F::B_VALS>(v, w);
    if constexpr (F32) {
      reinterpret_cast<uint4*>(ktiles)[f] = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      reinterpret_cast<uint2*>(ktiles)[f] = make_uint2(w[0], w[1]);
    }
  }
}

// B3. Grid: x = (m tile, n tile) with n fastest. Block (mt, nt) computes
// dx for flat pixels [64 mt, +64) and input channels [BN nt, +BN). Warps
// 0-7 consume (mma), warps 8-15 produce, in two groups of 4 that take
// alternate K steps. Dynamic shared memory: a ring of NST A tiles, then,
// if STAGED, two buffers of rows_bytes for the staged g rows (flat rows
// [fr_lo, fr_hi], PX_BYTES a pixel); else the producers read g in place.
template <typename T, int NF, bool STAGED>
__global__ void __launch_bounds__(NTHREADS, 1)
dx_s1_kernel(const T* __restrict__ g, const uint32_t* __restrict__ ktiles,
             const int4* __restrict__ slots, const int* __restrict__ counts,
             float* __restrict__ dx, int B, int H, int W, int Cin, int Cout, int smax, int dmin,
             int dmax, int rows_bytes) {
  using F = Frag<T>;
  using L = Layout<T>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int BN = 32 * NF;
  extern __shared__ __align__(16) uint32_t smem[];
  unsigned char* const b_smem = reinterpret_cast<unsigned char*>(smem + NST * L::A_STAGE);
  unsigned char* const rows_s = b_smem + 2 * L::SUB * BN * 32 * F::B_WORDS / 2;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int HW = H * W;
  const int P = B * HW;
  const int n_slabs = (Cout + L::OS - 1) / L::OS;
  const int n_steps = 9 * n_slabs;
  const int n_tiles = (Cin + 7) / 8;
  const int tiles_n = (Cin + BN - 1) / BN;
  const int p0 = (blockIdx.x / tiles_n) * BM;
  const int nt0 = (blockIdx.x % tiles_n) * (BN / 8);

  if (tid < CONSUMERS) {
    // ---- consumer: warp (wm, wn) computes pixels (2 wm + i) * 16 + .. x n8 tiles NF wn + f ----
    const int warp = tid >> 5;
    const int wm = warp >> 2;
    const int wn = warp & 3;
    // the block's B tile of K step s (its n8 tiles' fragments, contiguous
    // in ktiles) into B buffer s & 1 by cp.async, a step ahead; tiles past
    // Cin are not copied (their sums are never written)
    constexpr int B_CHUNKS = L::SUB * (BN / 8) * 32 * F::B_WORDS / 4;  // 16-byte chunks
    const int nt_valid = min(BN / 8, n_tiles - nt0);
    const int b_chunks = B_CHUNKS / (BN / 8) * nt_valid;
    auto copy_b = [&](int s) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(ktiles) +
                                 (((size_t)s * n_tiles + nt0) * L::SUB * 32 * F::B_WORDS) * 4;
      unsigned char* dst = b_smem + (s & 1) * B_CHUNKS * 16;
      for (int e = tid; e < b_chunks; e += CONSUMERS) cp_async16(dst + e * 16, src + e * 16, true);
      cp_async_commit();
    };
    float acc[2][NF][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][f][r] = 0.f;
    copy_b(0);
    for (int s = 0; s < n_steps; ++s) {
      const int k = s % NST;
      // B tile s landed (every consumer's copies), and every consumer is
      // done with step s - 1, whose buffer takes tile s + 1
      cp_async_wait_all();
      bar_sync(BAR_CONS, CONSUMERS);
      if (s + 1 < n_steps) copy_b(s + 1);
      bar_sync(BAR_FULL + k, CONSUMERS + GROUP);
      const uint32_t* a_s = smem + k * L::A_STAGE;
      const unsigned char* b_s = b_smem + (s & 1) * B_CHUNKS * 16;
      // the step's fragments: B from the block's tile, A from the ring
      auto load_frags = [&](int sb, uint32_t (&bf)[NF][F::B_WORDS], uint32_t (&a)[2][F::A_WORDS]) {
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const int fb = ((wn * NF + f) * L::SUB + sb) * 32 + lane;
          if constexpr (F32) {
            const uint4 u4 = reinterpret_cast<const uint4*>(b_s)[fb];
            bf[f][0] = u4.x;
            bf[f][1] = u4.y;
            bf[f][2] = u4.z;
            bf[f][3] = u4.w;
          } else {
            const uint2 u2 = reinterpret_cast<const uint2*>(b_s)[fb];
            bf[f][0] = u2.x;
            bf[f][1] = u2.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t* src = a_s + (sb * MT + 2 * wm + i) * 32 * F::A_WORDS + lane * 4;
#pragma unroll
          for (int hh = 0; hh < F::A_WORDS / 4; ++hh) {
            const uint4 u4 = *reinterpret_cast<const uint4*>(src + hh * 128);
            a[i][4 * hh] = u4.x;
            a[i][4 * hh + 1] = u4.y;
            a[i][4 * hh + 2] = u4.z;
            a[i][4 * hh + 3] = u4.w;
          }
        }
      };
      if constexpr (F32 && NF <= 4) {
        // the K step's 16 values (two k8 steps of three TF32 products)
        // summed from zero on the tensor cores, added here in f32
        uint32_t bf[L::SUB][NF][F::B_WORDS], a[L::SUB][2][F::A_WORDS];
#pragma unroll
        for (int sb = 0; sb < L::SUB; ++sb) load_frags(sb, bf[sb], a[sb]);
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int sb = 0; sb < L::SUB; ++sb) {
              mma_tf32(d, a[sb][i] + 4, bf[sb][f]);  // lo * hi
              mma_tf32(d, a[sb][i], bf[sb][f] + 2);  // hi * lo
              mma_tf32(d, a[sb][i], bf[sb][f]);      // hi * hi
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][f][r] += d[r];
          }
      } else {
        // each mma step (8 K values in f32, 16 in bf16) summed from zero on
        // the tensor cores, added here in f32 (the 256-wide f32 block has
        // no registers for both steps' fragments)
#pragma unroll
        for (int sb = 0; sb < L::SUB; ++sb) {
          uint32_t bf[NF][F::B_WORDS], a[2][F::A_WORDS];
          load_frags(sb, bf, a);
#pragma unroll
          for (int f = 0; f < NF; ++f)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              if constexpr (F32) {
                mma_tf32(d, a[i] + 4, bf[f]);  // lo * hi
                mma_tf32(d, a[i], bf[f] + 2);  // hi * lo
                mma_tf32(d, a[i], bf[f]);      // hi * hi
              } else {
                mma_bf16(d, a[i] + 4, bf[f]);  // Ĝ lo * K
                mma_bf16(d, a[i], bf[f]);      // Ĝ hi * K
              }
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[i][f][r] += d[r];
            }
        }
      }
      bar_arrive(BAR_EMPTY + k, CONSUMERS + GROUP);
    }

    // epilogue: pixels (2 wm + i) * 16 + lane / 4 (+8), channels 2 (lane % 4) (+1)
    const bool pair = Cin % 2 == 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + (2 * wm + i) * 16 + (lane >> 2) + 8 * h;
        if (p >= P) continue;
        float* row = dx + (size_t)p * Cin;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const int c = (nt0 + wn * NF + f) * 8 + 2 * (lane & 3);
          const float v0 = acc[i][f][2 * h], v1 = acc[i][f][2 * h + 1];
          if (pair && c < Cin) {
            *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
          } else {
            if (c < Cin) row[c] = v0;
            if (c + 1 < Cin) row[c + 1] = v1;
          }
        }
      }
    return;
  }

  // ---- producer: group pg combines the A tiles of K steps pg, pg + 2, ... ----
  const int ptid = tid - CONSUMERS;  // 0 .. 2 * GROUP - 1
  const int pg = ptid / GROUP;
  const int pt = ptid % GROUP;
  // the flat g rows the block's slots read
  const int fr_lo = max(0, p0 / W + dmin);
  const int fr_hi = min(B * H - 1, (min(p0 + BM, P) - 1) / W + dmax);
  const int n_px = (fr_hi - fr_lo + 1) * W;
  const bool g_vec = Cout % L::VEC == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;

  // warp w of a group combines m16 tile w of every K step: lane (g8, c)
  // the 16-byte chunk c of its pixels g8 and g8 + 8 (flat row, row, column
  // the same in every step), then a 4 x 4 transpose among the lanes of a
  // pixel leaves each lane its fragments' values
  const int mt = pt >> 5;
  const int c4 = lane & 3;
  int px_fr[2], px_row[2], px_col[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + mt * 16 + (lane >> 2) + 8 * h;
    const int fr = p / W;
    px_fr[h] = p < P ? fr : -1;
    px_row[h] = fr % H;
    px_col[h] = p - fr * W;
  }

  // a slab's g rows into rows buffer buf, by all producers
  auto load_rows = [&](int cs, int buf) {
    unsigned char* dst = rows_s + buf * rows_bytes;
    const T* src0 = g + (size_t)fr_lo * W * Cout + cs * L::OS;
    if (g_vec) {
      for (int e = ptid; e < n_px * 4; e += 2 * GROUP) {
        const int px = e >> 2;
        const int q = e & 3;
        const bool ok = cs * L::OS + q * L::VEC < Cout;
        cp_async16(dst + px * PX_BYTES + row_slot(px, q) * 16,
                   ok ? (const void*)(src0 + (size_t)px * Cout + q * L::VEC) : (const void*)g, ok);
      }
    } else {
      for (int e = ptid; e < n_px * L::OS; e += 2 * GROUP) {
        const int px = e / L::OS;
        const int ch = e - px * L::OS;
        const T v = cs * L::OS + ch < Cout ? src0[(size_t)px * Cout + ch] : T(0.f);
        reinterpret_cast<T*>(dst + px * PX_BYTES + row_slot(px, ch / L::VEC) * 16)[ch % L::VEC] = v;
      }
    }
    cp_async_commit();
  };

  // chunk c4 of slab cs at pixel spx of the block's rows (flat pixel
  // fr_lo * W + spx): from the staged buffer, or from g itself, 0 past Cout
  auto chunk = [&](const unsigned char* rows, int cs, int spx) -> uint4 {
    if constexpr (STAGED) {
      return *reinterpret_cast<const uint4*>(rows + spx * PX_BYTES + row_slot(spx, c4) * 16);
    } else {
      const int ch0 = cs * L::OS + c4 * L::VEC;
      const T* src = g + ((size_t)fr_lo * W + spx) * Cout + ch0;
      if (g_vec) return ch0 < Cout ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
      alignas(16) T v[L::VEC];
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) v[e] = ch0 + e < Cout ? src[e] : T(0.f);
      return *reinterpret_cast<const uint4*>(v);
    }
  };

  if constexpr (STAGED) load_rows(0, 0);
  for (int s = pg; s < n_steps; s += 2) {
    const int cs = s / 9;
    const int t = s - cs * 9;
    const int k = s % NST;
    if (STAGED && t <= 1) {
      // a new slab, entered by each group once: its rows landed (every
      // producer's copies), nobody reads the other buffer any more, so the
      // next slab's rows load into it while this slab's 9 taps run
      cp_async_wait_all();
      bar_sync(BAR_PROD, 2 * GROUP);
      if (cs + 1 < n_slabs) load_rows(cs + 1, (cs + 1) & 1);
    }
    if (s >= NST) bar_sync(BAR_EMPTY + k, CONSUMERS + GROUP);
    const unsigned char* rows = rows_s + (cs & 1) * rows_bytes;
    // G_t of chunk c4 at each pixel: the pixel's slots of (row, tap), their
    // reads of whole 16-byte chunks issued together (masked terms read
    // pixel 0 and are dropped), each value summed in slot order
    float sum[2][L::VEC];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int v = 0; v < L::VEC; ++v) sum[h][v] = 0.f;
      if (px_fr[h] < 0) continue;
      const int rt = px_row[h] * 9 + t;
      const int n = __ldg(counts + rt);
      const int4* sl_g = slots + (size_t)rt * smax;
      const int img0 = px_fr[h] - px_row[h] - fr_lo;  // staged row of the image's row 0
      const int col = px_col[h];
      uint4 raw[SLOT_BATCH];
      float wt[SLOT_BATCH];
#pragma unroll
      for (int m = 0; m < SLOT_BATCH; ++m) {
        const int4 e4 = __ldg(sl_g + (m < n ? m : 0));
        int j = col - e4.y;
        if (j < 0) j += W;
        const bool use = m < n && j != e4.z;
        const int spx = use ? (img0 + e4.x) * W + j : 0;
        wt[m] = use ? __int_as_float(e4.w) : 0.f;
        raw[m] = chunk(rows, cs, spx);
      }
#pragma unroll
      for (int m = 0; m < SLOT_BATCH; ++m) {
        if (wt[m] == 0.f) continue;
        float gv[L::VEC];
        Vec<T>::unpack(raw[m], gv);
#pragma unroll
        for (int v = 0; v < L::VEC; ++v) sum[h][v] = __fadd_rn(sum[h][v], __fmul_rn(wt[m], gv[v]));
      }
      for (int m = SLOT_BATCH; m < n; ++m) {  // more slots than a batch: none at the model's maps
        const int4 e4 = __ldg(sl_g + m);
        int j = col - e4.y;
        if (j < 0) j += W;
        if (j == e4.z) continue;
        float gv[L::VEC];
        Vec<T>::unpack(chunk(rows, cs, (img0 + e4.x) * W + j), gv);
#pragma unroll
        for (int v = 0; v < L::VEC; ++v)
          sum[h][v] = __fadd_rn(sum[h][v], __fmul_rn(__int_as_float(e4.w), gv[v]));
      }
    }
    // 4 words per pixel, hi and lo (f32: the values, split into TF32 hi and
    // lo below; bf16: pairs of bf16 hi, rounded to nearest, and of the bf16
    // of the rest), transposed: lane c4 then holds word c4 of chunks 0..3
    uint32_t wd[2][4], wl[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (F32) {
          wd[h][i] = __float_as_uint(sum[h][i]);
        } else {
          const float v0 = sum[h][2 * i], v1 = sum[h][2 * i + 1];
          wd[h][i] = pack_bf16(v0, v1);
          wl[h][i] = pack_bf16(v0 - __uint_as_float(wd[h][i] << 16),
                               v1 - __uint_as_float(wd[h][i] & 0xffff0000u));
        }
      }
      transpose4(wd[h], c4);
      if constexpr (!F32) transpose4(wl[h], c4);
    }
    uint32_t* slot = smem + k * L::A_STAGE;
#pragma unroll
    for (int sub = 0; sub < L::SUB; ++sub) {
      // fragment (sub, mt): rows g8, g8 + 8 at K values of chunks 2 sub, 2 sub + 1
      uint32_t* dst = slot + (sub * MT + mt) * 32 * F::A_WORDS + lane * 4;
      const uint32_t q[4] = {wd[0][2 * sub], wd[1][2 * sub], wd[0][2 * sub + 1],
                             wd[1][2 * sub + 1]};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (F32) {
          split_tf32(__uint_as_float(q[i]), hi[i], lo[i]);
        } else {
          hi[i] = q[i];
        }
      }
      if constexpr (!F32) {
        lo[0] = wl[0][2 * sub];
        lo[1] = wl[1][2 * sub];
        lo[2] = wl[0][2 * sub + 1];
        lo[3] = wl[1][2 * sub + 1];
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + 128) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    bar_arrive(BAR_FULL + k, CONSUMERS + GROUP);
  }
}

inline int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// the bytes of a rows buffer: the most flat rows a 64-pixel tile's slots
// read (tiles start at multiples of 64, so at residues mod W that are
// multiples of gcd(64, W)), widened by [dmin, dmax]
inline long long rows_buffer_bytes(int B, int H, int W, int dmin, int dmax) {
  const int span = (W - gcd(BM, W) + BM - 1) / W + 1;
  const int rows = span + dmax - dmin;
  return (long long)(rows < B * H ? rows : B * H) * W * PX_BYTES;
}

template <typename T, int NF, bool STAGED>
int launch_kernel(const void* g, const void* ktiles, const void* slots, const void* counts,
                  void* dx, int B, int H, int W, int Cin, int Cout, int smax, int dmin, int dmax,
                  long long rows_bytes, long long smem, long long blocks, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      dx_s1_kernel<T, NF, STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dx_s1_kernel<T, NF, STAGED><<<(unsigned)blocks, NTHREADS, (int)smem, st>>>(
      (const T*)g, (const uint32_t*)ktiles, (const int4*)slots, (const int*)counts, (float*)dx, B,
      H, W, Cin, Cout, smax, dmin, dmax, (int)rows_bytes);
  return (int)cudaGetLastError();
}

template <typename T, int NF>
int launch_main(const void* g, const void* ktiles, const void* slots, const void* counts,
                void* dx, int B, int H, int W, int Cin, int Cout, int smax, int dmin, int dmax,
                cudaStream_t st) {
  using L = Layout<T>;
  // the A ring and two B tiles (SUB * BN/8 n8 tiles of 32 lanes' B_WORDS
  // words), then two rows buffers where they fit
  const long long fixed = (long long)NST * L::A_STAGE * 4 +
                          2LL * L::SUB * (32 * NF / 8) * 32 * Frag<T>::B_WORDS * 4;
  const long long rows_bytes = rows_buffer_bytes(B, H, W, dmin, dmax);
  const bool staged = fixed + 2 * rows_bytes <= SMEM_MAX;
  const long long smem = fixed + (staged ? 2 * rows_bytes : 0);
  const long long blocks =
      (((long long)B * H * W + BM - 1) / BM) * ((Cin + 32 * NF - 1) / (32 * NF));
  if (blocks > 0x7fffffffLL || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  return staged ? launch_kernel<T, NF, true>(g, ktiles, slots, counts, dx, B, H, W, Cin, Cout,
                                             smax, dmin, dmax, rows_bytes, smem, blocks, st)
                : launch_kernel<T, NF, false>(g, ktiles, slots, counts, dx, B, H, W, Cin, Cout,
                                              smax, dmin, dmax, 0, smem, blocks, st);
}

template <typename T>
int launch(const void* g, const void* kmat, void* ktiles, const void* slots, const void* counts,
           void* dx, int B, int H, int W, int Cin, int Cout, int bn, int smax, int dmin, int dmax,
           void* stream) {
  using L = Layout<T>;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || smax < 1 || dmin > 0 || dmax < 0 ||
      (long long)B * H * W >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n_frags =
      9LL * ((Cout + L::OS - 1) / L::OS) * ((Cin + 7) / 8) * L::SUB * 32;
  const long long prep_blocks = (n_frags + PREP_THREADS - 1) / PREP_THREADS;
  dx_s1_kprep_kernel<T><<<(unsigned)(prep_blocks < 4096 ? prep_blocks : 4096), PREP_THREADS, 0,
                          st>>>((const T*)kmat, (uint32_t*)ktiles, Cin, Cout, n_frags);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  switch (bn) {
    case 256:
      return launch_main<T, 8>(g, ktiles, slots, counts, dx, B, H, W, Cin, Cout, smax, dmin, dmax, st);
    case 128:
      return launch_main<T, 4>(g, ktiles, slots, counts, dx, B, H, W, Cin, Cout, smax, dmin, dmax, st);
    case 64:
      return launch_main<T, 2>(g, ktiles, slots, counts, dx, B, H, W, Cin, Cout, smax, dmin, dmax, st);
    case 32:
      return launch_main<T, 1>(g, ktiles, slots, counts, dx, B, H, W, Cin, Cout, smax, dmin, dmax, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes. g (B,H,W,Cout) and kmat (9,Cin,Cout) in the
// named dtype; ktiles a scratch of 9 * ceil(Cout*size/64) * ceil(Cin/8) *
// 256 words (f32; 128 for bf16), size the dtype's bytes; slots (H,9,smax)
// int4 (out_row, shift, jdev, w0 bits) and counts (H,9) int32 of
// tap_grouped_tables, whose output rows lie in [r + dmin, r + dmax]; bn the
// block width (256, 128, 64 or 32); dx (B,H,W,Cin) f32, every value
// written. All contiguous on the device of `stream`. Returns the first
// nonzero cudaGetLastError() of the two launches.
extern "C" int sphere_conv_dx_s1_f32(const void* g, const void* kmat, void* ktiles,
                                     const void* slots, const void* counts, void* dx, int B,
                                     int H, int W, int Cin, int Cout, int bn, int smax, int dmin,
                                     int dmax, void* stream) {
  return launch<float>(g, kmat, ktiles, slots, counts, dx, B, H, W, Cin, Cout, bn, smax, dmin,
                       dmax, stream);
}

extern "C" int sphere_conv_dx_s1_bf16(const void* g, const void* kmat, void* ktiles,
                                      const void* slots, const void* counts, void* dx, int B,
                                      int H, int W, int Cin, int Cout, int bn, int smax, int dmin,
                                      int dmax, void* stream) {
  return launch<__nv_bfloat16>(g, kmat, ktiles, slots, counts, dx, B, H, W, Cin, Cout, bn, smax,
                               dmin, dmax, stream);
}
