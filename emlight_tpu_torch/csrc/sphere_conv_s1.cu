// Sphere conv forward, stride 1 — hand-written CUDA C++ for sm_90a (H100).
//
// Replaces emlight_tpu/nn/sphere_conv_pallas.py::_kernel at stride 1 (the
// Pallas TPU kernel B1, launched by sphere_conv_pallas). For each output
// pixel (b, i, j) and output channel o:
//
//   out[b,i,j,o] = bias[o] + sum_{t<9} sum_c S[b,i,j,t,c] * K[t,c,o]
//   S[b,i,j,t,c] = sum_{k<4} w(i,t,k,j) * x[b, rows[i,t,k], (j + shift[i,t,k]) mod W, c]
//   w(i,t,k,j)   = 0 if j == jdev[i,t,k] else w0[i,t,k]
//
// The (H, 9, 4) tables rows/shift/w0/jdev come from the port's
// structured_tables and scalar_weight_tables (nn/sphere_conv_kernel.py),
// which assert at build time that this decomposition is exact; the wrapper
// packs them per (i, t, k) as int4 (row, shift, jdev, w0 bits).
//
// What bounds it on an H100: operations. At the generator's widths a conv
// does 2*9*Cin*Cout flops per output pixel against (Cin + Cout) * 4 bytes of
// input and output, 100-1000 flops per byte; only the cin=3 and cout=3 convs
// sit below the ridge. The gather itself is cheap in bytes: the 4-neighbour
// sources of one output row lie in the input rows [i-2, i+1], a halo the L2
// and L1 keep hot.
//
// What this design does about it: an implicit GEMM on the tensor cores with
// wgmma, M = B*H*W flat output pixels (the batch folded in, so a tile of
// BM = 128 pixels crosses rows and images on small maps), N = Cout (BN =
// 128, or 64 when Cout <= 64), K = 9 taps x Cin, walked in steps of one tap
// and a 64-byte channel slab (BK = 16 f32 or 32 bf16), slab-major. f32
// multiplies in 3xTF32 (v ~ hi + lo, each rounded to TF32 with cvt.rna;
// lo*hi + hi*lo + hi*hi accumulate in f32, about 2^-21 relative per
// product, so f32 stays f32-accurate); bf16 as bf16 x bf16 with f32
// accumulation (S rounded to bf16 as the plain version does: the products
// are exact).
//
// Warp specialised: one block of 4 warpgroups per SM and a ring of NST = 3
// stages in shared memory, each holding one K step's A (S) and B (K_t) tile
// in wgmma's no-swizzle K-major layout (8-row x 16-byte core matrices).
// - Warpgroups 2 and 3 produce. The sampled operand S cannot be fetched by
//   a copy engine (each value is a weighted sum of 4 reads), and read
//   straight from device memory its 4 reads x 9 taps per input value bound
//   the kernel, not the tensor cores. So per channel slab the
//   producers cp.async the tile's source rows (its output rows widened by
//   the tables' row offsets, every column: the circular shifts reach any)
//   into one of two shared buffers, the next slab's while the current one's
//   9 taps are gathered, and gather S from there with 16-byte loads along
//   the channel axis (a rotation of the 16-byte slots keeps a quarter warp
//   on distinct banks). They split f32 S into TF32 hi and lo and store it
//   straight into the stage's A tile; one of them brings the B tile with
//   one cp.async.bulk, counted on the stage's `full` mbarrier. K_t is laid
//   out for that by s1_kprep_kernel before the main kernel: per (n tile,
//   K step) one contiguous tile, zero-padded, f32 split into hi and lo.
//   Where the rows do not fit (W above 256) or Cin is not a multiple
//   of the 16-byte vector, the producers gather from device memory instead.
// - Warpgroups 0 and 1 consume: each issues wgmma m64nBNk8 (tf32, three per
//   8 K rows: lo*hi, hi*lo, hi*hi) or m64nBNk16 (bf16) on its 64 rows of the
//   stage and releases it on its `empty` mbarrier. bf16 keeps one step's
//   group in flight. f32 sums each step from zero on the tensor cores and
//   adds the steps on the CUDA cores: the tensor cores' f32 accumulation
//   does not round to nearest, and chained over every step of a wide conv
//   its error grew far past the 2^-21 per product that 3xTF32 gives.
// Small maps, whose output tiles would leave SMs idle, split K over
// contiguous step ranges (s1_plan in nn/sphere_conv_kernel.py): each split
// writes an f32 partial, and split_sum_kernel adds them in split order, so
// the result is the same bits in every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // flat output pixels per tile: 2 consumer warpgroups x 64
constexpr int NST = 3;           // stages of the ring
constexpr int PX_BYTES = 64;     // a pixel's K step of channels: 16 f32 or 32 bf16
constexpr int SMEM_MAX = 232448; // shared memory a block can have on an H100
constexpr int CONSUMERS = 256;   // warpgroups 0 and 1: wgmma
constexpr int PRODUCERS = 256;   // warpgroups 2 and 3: gather S, bring K_t
constexpr int CONSUMER_REGS = 176;  // registers a thread after setmaxnreg: the
constexpr int PRODUCER_REGS = 80;   // consumers' f32 sums need the room
constexpr int NTHREADS = CONSUMERS + PRODUCERS;
constexpr int TAB = 36;          // 9 taps x 4 neighbours
constexpr int TAB_SMEM_MAX = 16384;  // table rows in shared memory up to this many bytes
constexpr int RED_THREADS = 256;
constexpr int PREP_THREADS = 256;

template <typename T>
struct Cfg;

template <>
struct Cfg<float> {
  static constexpr int BK = 16;    // input channels per K step (one tap)
  static constexpr int VEC = 4;    // elements per 16-byte chunk (a core-matrix row)
  static constexpr int PARTS = 2;  // TF32 hi and lo
  static constexpr int KSTEP = 8;  // wgmma K
};

template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int BK = 32;
  static constexpr int VEC = 8;
  static constexpr int PARTS = 1;
  static constexpr int KSTEP = 16;
};

template <typename T, int BN>
struct Tile {
  static constexpr int BK = Cfg<T>::BK;
  static constexpr int KC = BK / Cfg<T>::VEC;              // 16-byte chunks along K: 4
  static constexpr int SBO = KC * 128;                     // bytes between 8-row core-matrix groups
  static constexpr int A_PART = BM * BK * (int)sizeof(T);  // one part of the A tile
  static constexpr int B_PART = BN * BK * (int)sizeof(T);
  static constexpr int A_BYTES = Cfg<T>::PARTS * A_PART;
  static constexpr int B_BYTES = Cfg<T>::PARTS * B_PART;  // one cp.async.bulk
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int BAR_OFF = NST * STAGE;              // full[NST], empty[NST]
  static constexpr int TAB_OFF = BAR_OFF + 2 * NST * 8;    // the table, then the source rows
  static constexpr int NCH = BM * KC / PRODUCERS;          // S chunks per producer thread: 2
  static_assert(NCH * PRODUCERS == BM * KC, "S chunks divide over the producers");
  static_assert(BK * (int)sizeof(T) == PX_BYTES && KC == 4, "a pixel's K step is 4 chunks");
  static_assert(BK % Cfg<T>::KSTEP == 0 && Cfg<T>::KSTEP * (int)sizeof(T) == 32,
                "a wgmma step reads two 16-byte chunks of K");
};

// byte offset of row r, 16-byte chunk kc in a part of a tile (K-major,
// no swizzle: core matrices of 8 rows x 16 bytes, row groups SBO apart)
template <int KC>
__host__ __device__ constexpr int core_offset(int r, int kc) {
  return ((r >> 3) * KC + kc) * 128 + (r & 7) * 16;
}

inline int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// the most flat output rows (b * H + i) a tile of BM pixels spans: tiles
// start at multiples of BM, so at residues mod W that are multiples of
// gcd(BM, W)
inline int table_rows(int B, int H, int W) {
  const int span = (W - gcd(BM, W) + BM - 1) / W + 1;
  return span < B * H ? span : B * H;
}

inline int table_smem_bytes(int B, int H, int W) {
  const int bytes = table_rows(B, H, W) * TAB * (int)sizeof(int4);
  return bytes <= TAB_SMEM_MAX ? bytes : 0;
}

// the most input rows a tile's gather reads: its output rows widened by
// the tables' row offsets [dmin, dmax]
inline int source_rows(int B, int H, int W, int dmin, int dmax) {
  const int rows = table_rows(B, H, W) + dmax - dmin;
  return rows < B * H ? rows : B * H;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`; a
// wait of more than about a second is a fault of the kernel: trap rather
// than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 4000000000LL) __trap();
  }
}

// --- wgmma -----------------------------------------------------------------

// K-major, no swizzle: leading byte offset 128 (the next 16-byte chunk of
// K), stride byte offset sbo (the next group of 8 rows)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <typename T, int BN>
struct Mma;

template <>
struct Mma<float, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int s) {
    wgmma_tf32_n128(d, a, b, s);
  }
};

template <>
struct Mma<float, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int s) {
    wgmma_tf32_n64(d, a, b, s);
  }
};

template <>
struct Mma<__nv_bfloat16, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int s) {
    wgmma_bf16_n128(d, a, b, s);
  }
};

template <>
struct Mma<__nv_bfloat16, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int s) {
    wgmma_bf16_n64(d, a, b, s);
  }
};

// 16 bytes of x: VEC values kept raw in a uint4, unpacked to f32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static __device__ __forceinline__ void set(uint4& r, int v, float x) {
    (&r.x)[v] = __float_as_uint(x);
  }
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static __device__ __forceinline__ void set(uint4& r, int v, __nv_bfloat16 x) {
    const uint32_t bits = *reinterpret_cast<const unsigned short*>(&x);
    uint32_t& w = (&r.x)[v / 2];
    w = (v & 1) ? ((w & 0xffffu) | (bits << 16)) : ((w & 0xffff0000u) | bits);
  }
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// K_t for the bulk copies: tile (nt, s) at ((nt * n_steps + s) * B_BYTES)
// holds rows n = channels [nt * BN, +BN), K = channels [(s / 9) * BK, +BK)
// of tap s % 9, K-major in core matrices, 0 past Cin and Cout; f32 as the
// TF32 hi part then the lo part.
template <typename T, int BN>
__global__ void __launch_bounds__(PREP_THREADS)
s1_kprep_kernel(const T* __restrict__ kmat, unsigned char* __restrict__ ktiles, int Cin,
                int Cout, int n_steps) {
  using TL = Tile<T, BN>;
  constexpr int VEC = Cfg<T>::VEC;
  const int nt = blockIdx.x / n_steps;
  const int s = blockIdx.x - nt * n_steps;
  const int c0 = (s / 9) * TL::BK;
  const int t = s % 9;
  unsigned char* dst = ktiles + (size_t)blockIdx.x * TL::B_BYTES;
  for (int e = threadIdx.x; e < BN * TL::KC; e += PREP_THREADS) {
    const int n = e % BN;  // neighbouring threads, neighbouring output channels
    const int kc = e / BN;
    const int o = nt * BN + n;
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = c0 + kc * VEC + i;
      v[i] = (c < Cin && o < Cout) ? (float)kmat[((size_t)t * Cin + c) * Cout + o] : 0.f;
    }
    const int off = core_offset<TL::KC>(n, kc);
    if constexpr (sizeof(T) == 4) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = to_tf32(v[i]);
        lo[i] = to_tf32(v[i] - __uint_as_float(hi[i]));
      }
      *reinterpret_cast<uint4*>(dst + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + TL::B_PART + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      uint32_t pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        pk[i] = *reinterpret_cast<const uint32_t*>(&h2);
      }
      *reinterpret_cast<uint4*>(dst + off) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
}

// the 16-byte slot of chunk q of staged source pixel px: rotated by px / 2,
// so the 8 pixels a quarter warp reads fall on distinct banks
__device__ __forceinline__ int row_slot(int px, int q) { return (q + (px >> 1)) & 3; }

// B1. Grid: x = (m tile, n tile) with n fastest, y = K split. Block
// (mt, nt, split) accumulates steps [split * per, (split + 1) * per) of
// the 9 * ceil(Cin / BK) steps (step s: channel slab s / 9, tap s % 9) for
// pixels [mt * BM, +BM) and channels [nt * BN, +BN); with one split it adds
// the bias and writes out, else it writes partial[split]. STAGED: the
// producers bring each slab's source rows into shared memory (two buffers of
// rows_bytes, the next slab's loading while the current one's 9 taps are
// gathered) and gather S from there; else they gather from device memory.
template <typename T, int BN, bool STAGED>
__global__ void __launch_bounds__(NTHREADS, 1)
s1_kernel(const T* __restrict__ x, const unsigned char* __restrict__ ktiles,
          const float* __restrict__ bias, const int4* __restrict__ table,
          float* __restrict__ out, float* __restrict__ partial, int B, int H, int W, int Cin,
          int Cout, int per, int span, int tab_in_smem, int dmin, int dmax, int rows_bytes) {
  using TL = Tile<T, BN>;
  constexpr int BK = TL::BK;
  constexpr int VEC = Cfg<T>::VEC;
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TL::BAR_OFF);
  uint64_t* empty = full + NST;

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int M = B * HW;
  const int tiles_n = (Cout + BN - 1) / BN;
  const int nt = blockIdx.x % tiles_n;
  const int mt = blockIdx.x / tiles_n;
  const int m0 = mt * BM;
  const int n0 = nt * BN;
  const int n_steps = 9 * ((Cin + BK - 1) / BK);
  const int s_begin = blockIdx.y * per;
  const int n_local = min(n_steps, s_begin + per) - s_begin;

  if (tid == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(&full[st], PRODUCERS + 1);  // every producer, and the bulk copy's expect_tx
      mbar_init(&empty[st], 2);             // one thread of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < CONSUMERS) {
    // ---- consumer: warpgroup wg computes rows [64 wg, +64) x BN ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = tid >> 7;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const uint32_t base = smem_u32(smem);
    float step_acc[BN / 2];  // f32: one K step's sum, added to acc on the CUDA cores
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) step_acc[i] = 0.f;
    for (int i = 0; i < n_local; ++i) {
      const int st = i % NST;
      mbar_wait(&full[st], (i / NST) & 1);
      const uint32_t sa = base + st * TL::STAGE + wg * 8 * TL::SBO;
      const uint32_t sb = base + st * TL::STAGE + TL::A_BYTES;
      wgmma_fence();
      if constexpr (F32) {
        // the tensor cores' f32 sums round less carefully than an FMA:
        // each step (16 K values) is summed from zero there, and the steps
        // are added here, rounded to nearest, so f32 stays f32-accurate
#pragma unroll
        for (int kk = 0; kk < BK / Cfg<T>::KSTEP; ++kk) {
          const uint32_t off = kk * 256;  // two 16-byte chunks of K per wgmma
          Mma<T, BN>::run(step_acc, wgmma_desc(sa + TL::A_PART + off, TL::SBO),
                          wgmma_desc(sb + off, TL::SBO), kk > 0 ? 1 : 0);
          Mma<T, BN>::run(step_acc, wgmma_desc(sa + off, TL::SBO),
                          wgmma_desc(sb + TL::B_PART + off, TL::SBO), 1);
          Mma<T, BN>::run(step_acc, wgmma_desc(sa + off, TL::SBO),
                          wgmma_desc(sb + off, TL::SBO), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        if ((tid & 127) == 0) mbar_arrive(&empty[st]);
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[j] += step_acc[j];
      } else {
#pragma unroll
        for (int kk = 0; kk < BK / Cfg<T>::KSTEP; ++kk) {
          const uint32_t off = kk * 256;
          Mma<T, BN>::run(acc, wgmma_desc(sa + off, TL::SBO), wgmma_desc(sb + off, TL::SBO),
                          (i > 0 || kk > 0) ? 1 : 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's wgmmas are done with their stage
        if (i > 0 && (tid & 127) == 0) mbar_arrive(&empty[(i - 1) % NST]);
      }
    }
    wgmma_wait<0>();

    // epilogue: row 64 wg + 16 warp + g (+8), channels 8 j + 2 t4 (+1)
    const int lane = tid & 31;
    const int row = m0 + wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int col = n0 + 2 * (lane & 3);
    const bool split = gridDim.y > 1;
    float* dst = split ? partial + (size_t)blockIdx.y * M * Cout : out;
    const bool pair = Cout % 2 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = row + 8 * h;
      if (p >= M) continue;
      float* orow = dst + (size_t)p * Cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = col + 8 * j;
        float v0 = acc[4 * j + 2 * h];
        float v1 = acc[4 * j + 2 * h + 1];
        if (!split) {
          if (n < Cout) v0 += bias[n];
          if (n + 1 < Cout) v1 += bias[n + 1];
        }
        if (pair && n < Cout) {
          *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
        } else {
          if (n < Cout) orow[n] = v0;
          if (n + 1 < Cout) orow[n + 1] = v1;
        }
      }
    }
  } else {
    // ---- producer: S of each step into the stage's A tile, K_t by bulk copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = tid - CONSUMERS;
    const int fr0 = m0 / W;
    unsigned char* const rows_s = smem + TL::TAB_OFF + (tab_in_smem ? span * TAB * 16 : 0);
    const int4* tab = table;
    if (tab_in_smem) {
      int4* tab_s = reinterpret_cast<int4*>(smem + TL::TAB_OFF);
      for (int e = pt; e < span * TAB; e += PRODUCERS) {
        const int fr = fr0 + e / TAB;
        if (fr < B * H) tab_s[e] = table[(fr % H) * TAB + e % TAB];
      }
      tab = tab_s;
    }
    // chunk j: row pg * 8 + p8 of the tile, 16-byte chunk q of the K step;
    // a quarter warp writes the 8 rows of one core matrix (128 bytes)
    const int p8 = pt & 7;
    const int q = (pt >> 3) % TL::KC;
    int ch_tab[TL::NCH];  // table entry of the pixel's row, -1 past M
    int ch_j[TL::NCH];    // output column
    int ch_img[TL::NCH];  // first flat input row of the pixel's image (b * H)
    int ch_off[TL::NCH];  // byte offset of the chunk in a part of the A tile
#pragma unroll
    for (int j = 0; j < TL::NCH; ++j) {
      const int pg = pt / (8 * TL::KC) + j * (PRODUCERS / (8 * TL::KC));
      const int r = pg * 8 + p8;
      const int p = m0 + r;
      const int fr = p / W;
      ch_tab[j] = p < M ? (tab_in_smem ? fr - fr0 : fr % H) * TAB : -1;
      ch_j[j] = p - fr * W;
      ch_img[j] = (fr / H) * H;
      ch_off[j] = core_offset<TL::KC>(r, q);
    }
    const bool x_vec = Cin % VEC == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const unsigned char* ksrc = ktiles + (size_t)nt * n_steps * TL::B_BYTES;

    // STAGED: flat input rows [fr_lo, fr_lo + n_rows) of a slab, pixel-major,
    // PX_BYTES a pixel (chunk q in slot row_slot(px, q)), 0 past Cin
    const int fr_lo = max(0, fr0 + dmin);
    const int fr_hi = min(B * H - 1, (min(m0 + BM, M) - 1) / W + dmax);
    const int n_px = (fr_hi - fr_lo + 1) * W;
    const int s_first = s_begin / 9;
    auto load_rows = [&](int cs) {
      unsigned char* buf = rows_s + ((cs - s_first) & 1) * rows_bytes;
      const T* src0 = x + (size_t)fr_lo * W * Cin + cs * BK;
      if (x_vec) {
        for (int e = pt; e < n_px * TL::KC; e += PRODUCERS) {
          const int px = e >> 2;
          const int qq = e & 3;
          const bool ok = cs * BK + qq * VEC < Cin;
          cp_async16(buf + px * PX_BYTES + row_slot(px, qq) * 16,
                     ok ? src0 + (size_t)px * Cin + qq * VEC : x, ok);
        }
      } else {
        for (int e = pt; e < n_px * BK; e += PRODUCERS) {
          const int px = e / BK;
          const int ch = e - px * BK;
          const T v = cs * BK + ch < Cin ? src0[(size_t)px * Cin + ch] : T(0.f);
          reinterpret_cast<T*>(buf + px * PX_BYTES + row_slot(px, ch / VEC) * 16)[ch % VEC] = v;
        }
      }
    };
    if constexpr (STAGED) {
      load_rows(s_first);
      cp_async_commit();
    }
    if (tab_in_smem || STAGED) producers_sync();

    int cur = -1;
    for (int i = 0; i < n_local; ++i) {
      const int s = s_begin + i;
      const int cs = s / 9;
      const int t = s - cs * 9;
      if (STAGED && cs != cur) {
        producers_sync();  // every producer is done with slab cur's buffer
        if (cs + 1 <= (s_begin + n_local - 1) / 9) load_rows(cs + 1);
        cp_async_commit();
        cp_async_wait1();  // this slab's rows, from this thread's copies
        producers_sync();  // ... and everyone else's
        cur = cs;
      }
      const int st = i % NST;
      if (i >= NST) mbar_wait(&empty[st], ((i / NST) - 1) & 1);
      unsigned char* stage = smem + st * TL::STAGE;
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[st], TL::B_BYTES);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_u32(stage + TL::A_BYTES)),
            "l"(ksrc + (size_t)s * TL::B_BYTES), "r"(TL::B_BYTES), "r"(smem_u32(&full[st]))
            : "memory");
      }
      const int c = cs * BK + q * VEC;
      const unsigned char* rows = rows_s + ((cs - s_first) & 1) * rows_bytes;
      uint4 xr[TL::NCH][4];
      float wv[TL::NCH][4];
#pragma unroll
      for (int j = 0; j < TL::NCH; ++j) {
        const bool ok = ch_tab[j] >= 0 && c < Cin;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wv[j][k] = 0.f;
          xr[j][k] = make_uint4(0u, 0u, 0u, 0u);
          if (ok) {
            const int4 e = tab[ch_tab[j] + t * 4 + k];
            int col = ch_j[j] + e.y;
            if (col >= W) col -= W;
            wv[j][k] = ch_j[j] == e.z ? 0.f : __int_as_float(e.w);
            if (STAGED) {
              const int px = (ch_img[j] + e.x - fr_lo) * W + col;
              xr[j][k] = *reinterpret_cast<const uint4*>(rows + px * PX_BYTES +
                                                         row_slot(px, q) * 16);
            } else {
              const T* src = x + ((size_t)(ch_img[j] + e.x) * W + col) * Cin + c;
              if (x_vec) {
                xr[j][k] = *reinterpret_cast<const uint4*>(src);
              } else {
#pragma unroll
                for (int v = 0; v < VEC; ++v)
                  if (c + v < Cin) Vec<T>::set(xr[j][k], v, src[v]);
              }
            }
          }
        }
      }
      // the plain version's order: ((x0 w0 + x1 w1) + x2 w2) + x3 w3
#pragma unroll
      for (int j = 0; j < TL::NCH; ++j) {
        float v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float xq[VEC];
          Vec<T>::unpack(xr[j][k], xq);
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = __fadd_rn(v[e], __fmul_rn(xq[e], wv[j][k]));
        }
        if constexpr (F32) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[e] = to_tf32(v[e]);
            lo[e] = to_tf32(v[e] - __uint_as_float(hi[e]));
          }
          *reinterpret_cast<uint4*>(stage + ch_off[j]) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(stage + TL::A_PART + ch_off[j]) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        } else {
          uint32_t pk[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
            pk[e] = *reinterpret_cast<const uint32_t*>(&h2);
          }
          *reinterpret_cast<uint4*>(stage + ch_off[j]) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
        }
      }
      // the generic-proxy stores, then visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[st]);
    }
  }
}

// out[v] = bias[v % Cout] + sum over splits of partial[s][v], s in order
__global__ void __launch_bounds__(RED_THREADS)
split_sum_kernel(const float* __restrict__ partial, const float* __restrict__ bias,
                 float* __restrict__ out, long long n_values, int Cout, int n_split) {
  for (long long v = (long long)blockIdx.x * RED_THREADS + threadIdx.x; v < n_values;
       v += (long long)gridDim.x * RED_THREADS) {
    float s = partial[v];
    for (int k = 1; k < n_split; ++k) s += partial[k * n_values + v];
    out[v] = s + bias[v % Cout];
  }
}

template <typename T, int BN, bool STAGED>
int launch_main(const void* x, const void* ktiles, const void* bias, const void* table,
                void* partial, void* out, int B, int H, int W, int Cin, int Cout, int per,
                int n_split, int dmin, int dmax, int rows_bytes, int tab_bytes, int smem,
                unsigned blocks, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      s1_kernel<T, BN, STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  s1_kernel<T, BN, STAGED><<<dim3(blocks, n_split), NTHREADS, smem, st>>>(
      (const T*)x, (const unsigned char*)ktiles, (const float*)bias, (const int4*)table,
      (float*)out, (float*)partial, B, H, W, Cin, Cout, per, table_rows(B, H, W),
      tab_bytes > 0 ? 1 : 0, dmin, dmax, rows_bytes);
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int launch_bn(const void* x, const void* kmat, const void* bias, const void* table,
              void* ktiles, void* partial, void* out, int B, int H, int W, int Cin, int Cout,
              int per, int n_split, int dmin, int dmax, cudaStream_t st) {
  using TL = Tile<T, BN>;
  const int tab_bytes = table_smem_bytes(B, H, W);
  // the source rows in shared memory (double-buffered) where they fit and
  // come in 16-byte chunks
  const long long rows_bytes = (long long)source_rows(B, H, W, dmin, dmax) * W * PX_BYTES;
  const bool staged = TL::TAB_OFF + tab_bytes + 2 * rows_bytes <= SMEM_MAX &&
                      Cin % Cfg<T>::VEC == 0;
  const int smem = TL::TAB_OFF + tab_bytes + (staged ? 2 * (int)rows_bytes : 0);
  const long long M = (long long)B * H * W;
  const int tiles_n = (Cout + BN - 1) / BN;
  const long long blocks = ((M + BM - 1) / BM) * tiles_n;
  const int n_steps = 9 * ((Cin + TL::BK - 1) / TL::BK);
  if (blocks > 0x7fffffffLL || n_split > 65535 || (long long)tiles_n * n_steps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  s1_kprep_kernel<T, BN><<<tiles_n * n_steps, PREP_THREADS, 0, st>>>(
      (const T*)kmat, (unsigned char*)ktiles, Cin, Cout, n_steps);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = staged ? launch_main<T, BN, true>(x, ktiles, bias, table, partial, out, B, H, W, Cin,
                                         Cout, per, n_split, dmin, dmax, (int)rows_bytes,
                                         tab_bytes, smem, (unsigned)blocks, st)
              : launch_main<T, BN, false>(x, ktiles, bias, table, partial, out, B, H, W, Cin,
                                          Cout, per, n_split, dmin, dmax, 0, tab_bytes, smem,
                                          (unsigned)blocks, st);
  if (rc || n_split == 1) return rc;
  const long long n_values = M * Cout;
  const long long grid = (n_values + RED_THREADS - 1) / RED_THREADS;
  split_sum_kernel<<<(unsigned)(grid < 4096 ? grid : 4096), RED_THREADS, 0, st>>>(
      (const float*)partial, (const float*)bias, (float*)out, n_values, Cout, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* kmat, const void* bias, const void* table, void* ktiles,
           void* partial, void* out, int B, int H, int W, int Cin, int Cout, int bn, int bk,
           int per, int n_split, int dmin, int dmax, void* stream) {
  constexpr int BK = Cfg<T>::BK;
  const int n_steps = 9 * ((Cin + BK - 1) / BK);
  // the plan (nn/sphere_conv_kernel.py::s1_plan) must cover every step,
  // each split non-empty
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || bk != BK || per < 1 || n_split < 1 ||
      (long long)per * n_split < n_steps || (long long)per * (n_split - 1) >= n_steps ||
      dmin > 0 || dmax < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bn == 128)
    return launch_bn<T, 128>(x, kmat, bias, table, ktiles, partial, out, B, H, W, Cin, Cout,
                             per, n_split, dmin, dmax, st);
  if (bn == 64)
    return launch_bn<T, 64>(x, kmat, bias, table, ktiles, partial, out, B, H, W, Cin, Cout,
                            per, n_split, dmin, dmax, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface for ctypes. x (B,H,W,Cin) and kmat (9,Cin,Cout) in the
// named dtype, bias (Cout,) f32, table (H,9,4) int4 (row, shift, jdev, w0
// bits) whose source rows lie in [i + dmin, i + dmax], out (B,H,W,Cout)
// f32; all contiguous on the device of `stream`. (bn, bk, per, n_split) is
// s1_plan's: tile width, K step depth, steps per split and split count.
// ktiles is a byte scratch of tiles_n * n_steps * bn * bk * sizeof(dtype)
// (twice that for f32: TF32 hi and lo); with n_split > 1, partial is an f32
// scratch of n_split * B*H*W * Cout. Returns the first nonzero
// cudaGetLastError() of the launches.
extern "C" int sphere_conv_s1_f32(const void* x, const void* kmat, const void* bias,
                                  const void* table, void* ktiles, void* partial, void* out,
                                  int B, int H, int W, int Cin, int Cout, int bn, int bk, int per,
                                  int n_split, int dmin, int dmax, void* stream) {
  return launch<float>(x, kmat, bias, table, ktiles, partial, out, B, H, W, Cin, Cout, bn, bk,
                       per, n_split, dmin, dmax, stream);
}

extern "C" int sphere_conv_s1_bf16(const void* x, const void* kmat, const void* bias,
                                   const void* table, void* ktiles, void* partial, void* out,
                                   int B, int H, int W, int Cin, int Cout, int bn, int bk,
                                   int per, int n_split, int dmin, int dmax, void* stream) {
  return launch<__nv_bfloat16>(x, kmat, bias, table, ktiles, partial, out, B, H, W, Cin, Cout,
                               bn, bk, per, n_split, dmin, dmax, stream);
}
