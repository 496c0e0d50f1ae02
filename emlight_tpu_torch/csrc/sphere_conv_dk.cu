// Sphere conv kernel gradient (dK), strides 1 and 2 — hand-written CUDA C++
// for sm_90a (H100).
//
// Replaces emlight_tpu/nn/sphere_conv_vjp.py::_dk_kernel (the Pallas TPU
// kernel B4, launched by _dk_pallas). For the input x (B, H, W, Cin) and the
// cotangent g (B, Ho, Wo, Cout) of a stride-s sphere conv:
//
//   dK[t, c, o] = sum_{b, i, j} S_t[b, i, j, c] * g[b, i, j, o]
//   S_t[b,i,j,c] = sum_{k<4} w(i,t,k,j) * x[b, rows[i,t,k], (s*j + shift[i,t,k]) mod W, c]
//   w(i,t,k,j)   = 0 if j == jdev[i,t,k] else w0[i,t,k]
//
// with the forward's structured tables, packed per (i, t, k) as int4 (row,
// shift, jdev, w0 bits), so S_t is exactly the operand the forward samples.
// The JAX package takes the XLA gather formulation at stride 2 (_bwd); this
// kernel serves both strides.
//
// What bounds it on an H100: operations, 2*9*Cin*Cout flops per output
// pixel, reduced over up to 262,144 pixels into a small (9, Cin, Cout)
// result: a GEMM with M = 9*Cin (tap-major rows m = t*Cin + c), N = Cout and
// a long K, the B*Ho*Wo pixels, whose A operand (S) is gathered.
//
// What this design does about it: the product runs on the tensor cores with
// mma.sync, m16n8k8 TF32 for f32 (3xTF32: v = hi + lo, hi cut to TF32, lo
// the exact rest, of which the tensor cores read TF32's bits; lo*hi + hi*lo
// + hi*hi, about 2^-20 relative per product) and m16n8k16
// bf16 x bf16 for bf16 (S rounded to bf16 as the plain version rounds it:
// the products are exact). Each 8- or 16-pixel step is summed from zero on
// the tensor cores and added to the block's sums in f32 on the CUDA cores:
// their f32 accumulation, chained over a K this long, does not round to
// nearest (the forward kernel found so). mma.sync and not wgmma: for tf32,
// wgmma reads both operands only K-major from shared memory, and here K is
// the pixel axis along which neither x nor g is contiguous; mma.sync's
// fragments are plain register loads, so the staging threads write S and g
// straight into a fragment-native layout (each lane's 4 words of a fragment
// in one 16-byte slot: conflict-free 16-byte stores and loads), with the
// TF32 split on the way. bf16 takes the same route, so one design serves
// both.
// - One block per (64 rows of M, BN = 32..256 output channels, pixel
//   chunk), one block per SM. BN is as wide as Cout allows (dk_plan in
//   nn/sphere_conv_kernel.py: 256 for Cout >= 256), so each S value is
//   gathered once per block row and not once per 64-channel tile. Rows run
//   over the flattened (tap, channel) axis, so Cin = 3 or 6 fold all 9 taps
//   into one 64-row tile (27 or 54 rows) instead of nine nearly empty ones.
// - Warp-specialised, 16 warps: warps 8-15 produce, in two groups of 4 that
//   take alternate slabs of 16 pixels, into a ring of 4 slots. A group
//   copies the slab's g tile as it lies ([pixel][channel], rows padded so
//   the consumers' fragment reads fall on distinct banks) by cp.async,
//   tables the slab's gather (source pixel and weight per pixel, tap and
//   neighbour for the taps of the block's rows; the circular shift and the
//   dead column applied), and forms S (the 4 neighbours of a value read
//   together through the read-only cache, summed in the plain version's
//   order) in a fragment-native layout (a lane's words of a fragment in one
//   16-byte slot), f32 split into TF32 hi and lo. Warps 0-7 consume: they
//   read their B fragments from the g tile, splitting f32 on the way, and
//   each slab is one 16-deep step summed from zero on the
//   tensor cores and added to the block's sums in f32. Named barriers mark
//   a slot full and empty.
// - Ragged edges are masked where they are read: rows past 9*Cin, channels
//   past Cout and pixels past the chunk stage as 0; no padded copy exists.
// - The pixel axis is cut into chunks (dk_plan: enough to give each of
//   the 132 SMs a block, with the partial buffer capped). Each chunk writes an f32 partial and
//   dk_reduce_kernel sums them in chunk order; with one chunk the block
//   writes dK itself. No atomics: the result is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 256;  // warps 0-7: mma, 2 along M x 4 along N
constexpr int GROUP = 128;      // a producer group: 4 warps
constexpr int NTHREADS = CONSUMERS + 2 * GROUP;
constexpr int BM = 64;          // rows of M = 9 * Cin per block
constexpr int MT = BM / 16;     // m16 tiles per block
constexpr int KS = 16;          // pixels per slab
constexpr int NST = 4;          // slabs in the ring
constexpr int TAB_ENTRIES = KS * 9 * 4;  // a slab's (pixel, tap, neighbour) gather
// named barriers (0 is __syncthreads): a slot full, a slot empty, a group's
constexpr int BAR_FULL = 1, BAR_EMPTY = BAR_FULL + NST, BAR_GROUP = BAR_EMPTY + NST;
constexpr int RED_THREADS = 256;
constexpr int SMEM_MAX = 232448;

// The A fragments, per dtype: A is m16 x k, row-major (rows of M, pixels);
// a lane holds A_VALS values of one in A_WORDS words, value v at row a_row
// and pixel a_k. B (k x n8: pixels, output channels) is read from g as it
// lies.
template <typename T>
struct Frag;

template <>
struct Frag<float> {
  static constexpr int KSTEP = 8;
  static constexpr int A_VALS = 4, A_WORDS = 8;  // a0..a3 as TF32 hi, then lo
  static __device__ __forceinline__ int a_row(int lane, int v) { return (lane >> 2) + 8 * (v & 1); }
  static __device__ __forceinline__ int a_k(int lane, int v) { return (lane & 3) + 4 * (v >> 1); }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float load(float v) { return v; }
};

template <>
struct Frag<__nv_bfloat16> {
  static constexpr int KSTEP = 16;
  static constexpr int A_VALS = 8, A_WORDS = 4;  // register r holds values 2r, 2r+1
  static __device__ __forceinline__ int a_row(int lane, int v) {
    return (lane >> 2) + 8 * ((v >> 1) & 1);
  }
  static __device__ __forceinline__ int a_k(int lane, int v) {
    return 2 * (lane & 3) + 8 * (v >> 2) + (v & 1);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
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
// words, bf16 as packed pairs
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

template <typename T, int NF>
struct Layout {
  using F = Frag<T>;
  static constexpr int BN = 32 * NF;           // output channels per block
  static constexpr int SUB = KS / F::KSTEP;    // mma steps per slab
  static constexpr int A_FR = SUB * MT * 32;   // lane fragments of A per slab
  static constexpr int A_STAGE = A_FR * F::A_WORDS;  // words
  // g as it lies, [KS pixels][BN channels], rows padded by 8 channels so
  // the lanes of a fragment read distinct banks
  static constexpr int G_PITCH = BN + 8;       // channels
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int B_STAGE = KS * G_PITCH * (int)sizeof(T) / 4;  // words
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int A_PER = A_FR / GROUP;   // lane fragments a producer stages per slab
  // bytes: the ring, then two gather tables per producer group
  static constexpr int SMEM = NST * STAGE * 4 + 4 * TAB_ENTRIES * 8;
  static_assert(A_PER * GROUP == A_FR, "fragments divide over a group");
  static_assert(G_PITCH * (int)sizeof(T) % 16 == 0, "g rows in 16-byte chunks");
  static_assert(SMEM <= SMEM_MAX, "the ring fits in shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes, 0 bytes read (and zeros written) when !ok
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

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// B4. Grid: x = (m tile, n tile) with n fastest, y = pixel chunk. Block
// (mt, nt, z) sums dK rows [64 mt, +64) x channels [BN nt, +BN) over pixels
// [z * chunk, +chunk); with one chunk it writes dk, else partial[z].
// Warps 0-7 consume (mma), warps 8-15 produce, in two groups of 4 that take
// alternate slabs.
template <typename T, int NF, int S>
__global__ void __launch_bounds__(NTHREADS, 1)
dk_kernel(const T* __restrict__ x, const T* __restrict__ g, const int4* __restrict__ table,
          float* __restrict__ partial, float* __restrict__ dk, int B, int H, int W, int Cin,
          int Cout, int chunk) {
  using F = Frag<T>;
  using L = Layout<T, NF>;
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) uint32_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int M = 9 * Cin;
  const int Ho = H / S, Wo = W / S, Po = Ho * Wo;
  const int tiles_n = (Cout + L::BN - 1) / L::BN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * L::BN;
  const int q_begin = blockIdx.y * chunk;
  const int q_end = min(q_begin + chunk, B * Po);
  const int n_slabs = (q_end - q_begin + KS - 1) / KS;

  if (tid < CONSUMERS) {
    // ---- consumer: warp (wm, wn) sums rows (2 wm + i) * 16 + .. x n8 tiles NF wn + f ----
    const int warp = tid >> 5;
    const int wm = warp >> 2;
    const int wn = warp & 3;
    float acc[2][NF][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][f][r] = 0.f;
    for (int slab = 0; slab < n_slabs; ++slab) {
      const int k = slab % NST;
      bar_sync(BAR_FULL + k, CONSUMERS + GROUP);
      const uint32_t* a_s = smem + k * L::STAGE;
      const uint32_t* b_s = a_s + L::A_STAGE;
      uint32_t a[L::SUB][2][F::A_WORDS];
#pragma unroll
      for (int sub = 0; sub < L::SUB; ++sub)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t* src = a_s + (sub * MT + 2 * wm + i) * 32 * F::A_WORDS + lane * 4;
#pragma unroll
          for (int h = 0; h < F::A_WORDS / 4; ++h) {
            const uint4 u = *reinterpret_cast<const uint4*>(src + h * 128);
            a[sub][i][4 * h] = u.x;
            a[sub][i][4 * h + 1] = u.y;
            a[sub][i][4 * h + 2] = u.z;
            a[sub][i][4 * h + 3] = u.w;
          }
        }
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        // B fragments from g as it lies: pixel k, channel n of the n8 tile
        const int n = (wn * NF + f) * 8 + (lane >> 2);
        uint32_t b[L::SUB][4];  // f32: b0, b1 hi, then lo; bf16: b0, b1
#pragma unroll
        for (int sub = 0; sub < L::SUB; ++sub) {
          if constexpr (F32) {
            const float* gs = reinterpret_cast<const float*>(b_s) + n;
            const int k0 = sub * 8 + (lane & 3);
            const float v0 = gs[k0 * L::G_PITCH], v1 = gs[(k0 + 4) * L::G_PITCH];
            split_tf32(v0, b[sub][0], b[sub][2]);
            split_tf32(v1, b[sub][1], b[sub][3]);
          } else {
            const unsigned short* gs = reinterpret_cast<const unsigned short*>(b_s) + n;
            const int k0 = 2 * (lane & 3);
            b[sub][0] = gs[k0 * L::G_PITCH] | ((uint32_t)gs[(k0 + 1) * L::G_PITCH] << 16);
            b[sub][1] = gs[(k0 + 8) * L::G_PITCH] | ((uint32_t)gs[(k0 + 9) * L::G_PITCH] << 16);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // the slab's 16 pixels summed from zero on the tensor cores (two
          // k8 steps of three TF32 products in f32, one k16 step in bf16),
          // added here in f32
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int sub = 0; sub < L::SUB; ++sub) {
            if constexpr (F32) {
              mma_tf32(d, a[sub][i] + 4, b[sub]);  // lo * hi
              mma_tf32(d, a[sub][i], b[sub] + 2);  // hi * lo
              mma_tf32(d, a[sub][i], b[sub]);      // hi * hi
            } else {
              mma_bf16(d, a[sub][i], b[sub]);
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][f][r] += d[r];
        }
      }
      bar_arrive(BAR_EMPTY + k, CONSUMERS + GROUP);
    }

    // epilogue: rows (2 wm + i) * 16 + lane / 4 (+8), channels 2 (lane % 4) (+1)
    float* dst = gridDim.y > 1 ? partial + (size_t)blockIdx.y * M * Cout : dk;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = m0 + (2 * wm + i) * 16 + (lane >> 2) + 8 * (r >> 1);
          const int n = n0 + (wn * NF + f) * 8 + 2 * (lane & 3) + (r & 1);
          if (m < M && n < Cout) dst[(size_t)m * Cout + n] = acc[i][f][r];
        }
    return;
  }

  // ---- producer: group pg stages slabs pg, pg + 2, ... ----
  const int pg = (tid - CONSUMERS) / GROUP;
  const int pt = (tid - CONSUMERS) % GROUP;

  // the rows of this thread's A lane fragments (the same in every slab):
  // tap and channel of rows lane/4 and lane/4 + 8, tap -1 past M
  int row_t[L::A_PER][2], row_c[L::A_PER][2];
#pragma unroll
  for (int u = 0; u < L::A_PER; ++u) {
    const int mt = ((pt + u * GROUP) >> 5) % MT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mt * 16 + (lane >> 2) + 8 * h;
      row_t[u][h] = m < M ? m / Cin : -1;
      row_c[u][h] = m < M ? m - (m / Cin) * Cin : 0;
    }
  }

  // a slab's gather for the taps of the block's rows: (source pixel,
  // weight) of every (pixel, tap, neighbour), the circular shift and the
  // dead column applied; two buffers per group, a group barrier between
  // building one and reading it
  const int t_lo = m0 / Cin;
  const int n_taps = min(M - 1, m0 + BM - 1) / Cin - t_lo + 1;
  const bool g_vec = Cout % L::VEC == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  int2* const tabs = reinterpret_cast<int2*>(smem + NST * L::STAGE);

  for (int slab = pg; slab < n_slabs; slab += 2) {
    const int k = slab % NST;
    const int q0 = q_begin + slab * KS;
    int2* const tab = tabs + (pg * 2 + ((slab >> 1) & 1)) * TAB_ENTRIES;
    for (int e = pt; e < KS * n_taps * 4; e += GROUP) {
      const int nb = e & 3;
      const int px = (e >> 2) / n_taps;
      const int t = t_lo + (e >> 2) - px * n_taps;
      const int q = q0 + px;
      int2 v = make_int2(0, 0);
      if (q < q_end) {
        const int b = q / Po;
        const int p = q - b * Po;
        const int i = p / Wo;
        const int j = p - i * Wo;
        const int4 te = __ldg(table + (i * 9 + t) * 4 + nb);
        int col = S * j + te.y;
        if (col >= W) col -= W;
        v = make_int2((b * H + te.x) * W + col, j == te.z ? 0 : te.w);
      }
      tab[e] = v;
    }
    bar_sync(BAR_GROUP + pg, GROUP);
    if (slab >= NST) bar_sync(BAR_EMPTY + k, CONSUMERS + GROUP);
    uint32_t* a_s = smem + k * L::STAGE;
    unsigned char* b_s = reinterpret_cast<unsigned char*>(a_s + L::A_STAGE);

    // g as it lies: 16-byte chunks by cp.async (0 past the chunk's pixels
    // and Cout), by plain loads where Cout is not a multiple of the chunk
    if (g_vec) {
      for (int e = pt; e < KS * (L::BN / L::VEC); e += GROUP) {
        const int px = e / (L::BN / L::VEC);
        const int ch = (e - px * (L::BN / L::VEC)) * L::VEC;
        const bool ok = q0 + px < q_end && n0 + ch < Cout;
        cp_async16(b_s + (px * L::G_PITCH + ch) * (int)sizeof(T),
                   ok ? (const void*)(g + (size_t)(q0 + px) * Cout + n0 + ch) : (const void*)g, ok);
      }
      cp_async_commit();
    } else {
      for (int e = pt; e < KS * L::BN; e += GROUP) {
        const int px = e / L::BN;
        const int ch = e - px * L::BN;
        const bool ok = q0 + px < q_end && n0 + ch < Cout;
        reinterpret_cast<T*>(b_s)[px * L::G_PITCH + ch] =
            ok ? g[(size_t)(q0 + px) * Cout + n0 + ch] : T(0.f);
      }
    }

    // S: the 4 neighbours of every value issued together, summed in the
    // plain version's order ((x0 w0 + x1 w1) + x2 w2) + x3 w3, rounded to T
#pragma unroll
    for (int u = 0; u < L::A_PER; ++u) {
      const int f = pt + u * GROUP;
      const int sub = (f >> 5) / MT;
      float xv[F::A_VALS][4], wv[F::A_VALS][4];
#pragma unroll
      for (int e = 0; e < F::A_VALS; ++e) {
        const int h = (F::a_row(lane, e) - (lane >> 2)) >> 3;
        const int t = row_t[u][h];
        const int px = sub * F::KSTEP + F::a_k(lane, e);
        const int2* e2 = tab + (px * n_taps + (t >= 0 ? t - t_lo : 0)) * 4;
        const T* xc = x + row_c[u][h];
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int2 te = e2[nb];
          xv[e][nb] = F::load(__ldg(xc + (size_t)te.x * Cin));
          wv[e][nb] = t >= 0 ? __int_as_float(te.y) : 0.f;
        }
      }
      float v[F::A_VALS];
#pragma unroll
      for (int e = 0; e < F::A_VALS; ++e) {
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) sum = __fadd_rn(sum, __fmul_rn(xv[e][nb], wv[e][nb]));
        v[e] = F::round(sum);
      }
      uint32_t w[F::A_WORDS];
      pack_words<F32, F::A_VALS>(v, w);
      uint32_t* dst = a_s + (f >> 5) * 32 * F::A_WORDS + lane * 4;
#pragma unroll
      for (int h = 0; h < F::A_WORDS / 4; ++h)
        *reinterpret_cast<uint4*>(dst + h * 128) =
            make_uint4(w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]);
    }

    cp_async_wait_all();  // this thread's chunks of g landed
    bar_arrive(BAR_FULL + k, CONSUMERS + GROUP);
  }
}

__global__ void __launch_bounds__(RED_THREADS)
dk_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dk, int n, int n_chunks) {
  const int idx = blockIdx.x * RED_THREADS + threadIdx.x;
  if (idx >= n) return;
  float s = partial[idx];
  for (int z = 1; z < n_chunks; ++z) s += partial[(size_t)z * n + idx];
  dk[idx] = s;
}

template <typename T, int NF, int S>
int launch_main(const void* x, const void* g, const void* table, void* partial, void* dk, int B,
                int H, int W, int Cin, int Cout, int chunk, int n_chunks, cudaStream_t st) {
  using L = Layout<T, NF>;
  const cudaError_t e =
      cudaFuncSetAttribute(dk_kernel<T, NF, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((9 * Cin + BM - 1) / BM) * ((Cout + L::BN - 1) / L::BN);
  if (blocks > 0x7fffffffLL || n_chunks > 65535) return (int)cudaErrorInvalidValue;
  dk_kernel<T, NF, S><<<dim3((unsigned)blocks, n_chunks), NTHREADS, L::SMEM, st>>>(
      (const T*)x, (const T*)g, (const int4*)table, (float*)partial, (float*)dk, B, H, W, Cin,
      Cout, chunk);
  return (int)cudaGetLastError();
}

template <typename T, int S>
int launch_s(const void* x, const void* g, const void* table, void* partial, void* dk, int B,
             int H, int W, int Cin, int Cout, int bn, int chunk, int n_chunks, cudaStream_t st) {
  switch (bn) {
    case 256:
      return launch_main<T, 8, S>(x, g, table, partial, dk, B, H, W, Cin, Cout, chunk, n_chunks, st);
    case 128:
      return launch_main<T, 4, S>(x, g, table, partial, dk, B, H, W, Cin, Cout, chunk, n_chunks, st);
    case 64:
      return launch_main<T, 2, S>(x, g, table, partial, dk, B, H, W, Cin, Cout, chunk, n_chunks, st);
    case 32:
      return launch_main<T, 1, S>(x, g, table, partial, dk, B, H, W, Cin, Cout, chunk, n_chunks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* table, void* partial, void* dk, int B, int H,
           int W, int Cin, int Cout, int stride, int bn, int chunk, int n_chunks, void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)B * (H / stride) * (W / stride);
  // the plan (nn/sphere_conv_kernel.py::dk_plan) must cover every pixel,
  // each chunk a whole number of slabs and non-empty
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 ||
      chunk < KS || chunk % KS || n_chunks < 1 || (long long)chunk * n_chunks < n_pix ||
      (long long)chunk * (n_chunks - 1) >= n_pix)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = stride == 1
                     ? launch_s<T, 1>(x, g, table, partial, dk, B, H, W, Cin, Cout, bn, chunk, n_chunks, st)
                     : launch_s<T, 2>(x, g, table, partial, dk, B, H, W, Cin, Cout, bn, chunk, n_chunks, st);
  if (rc || n_chunks == 1) return rc;
  const int n = 9 * Cin * Cout;
  dk_reduce_kernel<<<(n + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0, st>>>(
      (const float*)partial, (float*)dk, n, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. x (B,H,W,Cin) and g (B,H/stride,W/stride,Cout)
// in the named dtype; table (H/stride,9,4) int4 (row, shift, jdev, w0 bits);
// (bn, chunk, n_chunks) dk_plan's: block width (256, 128, 64 or 32), pixels
// per chunk (a multiple of 16) and chunk count; partial an f32 scratch of
// n_chunks*9*Cin*Cout values (unused with one chunk); dk (9,Cin,Cout) f32.
// All contiguous on the device of `stream`. Returns the first nonzero
// cudaGetLastError() of the launches.
extern "C" int sphere_conv_dk_f32(const void* x, const void* g, const void* table, void* partial,
                                  void* dk, int B, int H, int W, int Cin, int Cout, int stride,
                                  int bn, int chunk, int n_chunks, void* stream) {
  return launch<float>(x, g, table, partial, dk, B, H, W, Cin, Cout, stride, bn, chunk, n_chunks,
                       stream);
}

extern "C" int sphere_conv_dk_bf16(const void* x, const void* g, const void* table, void* partial,
                                   void* dk, int B, int H, int W, int Cin, int Cout, int stride,
                                   int bn, int chunk, int n_chunks, void* stream) {
  return launch<__nv_bfloat16>(x, g, table, partial, dk, B, H, W, Cin, Cout, stride, bn, chunk,
                               n_chunks, stream);
}
