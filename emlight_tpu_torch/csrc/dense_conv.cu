// DenseNet dense-layer 3x3 conv with the BatchNorm affine fused into its read,
// forward (B7), input gradient (B7') and kernel gradient (B8) — hand-written
// CUDA C++ for sm_90a (H100).
//
// Replaces emlight_tpu/nn/dense_conv_pallas.py::_conv_kernel (the Pallas TPU
// body of _fwd_pallas, B7, and of _dx_pallas in its dx mode, B7') and
// ::_dk_kernel (_dk_pallas, B8). For x (B, H, W, Cin), the per-channel
// affine a, b (Cin) f32 and the kernel K (3, 3, Cin, Cout) HWIO:
//
//   y        = x * a + b, rounded to x's dtype, and 0 outside the image
//   out[p]   = sum_t y[p + off_t] @ K_t                    (B7, SAME conv)
//   dy2[q]   = sum_t g[q - off_t] @ K_t^T                  (B7', the conv of g
//              with the tap-reversed, transposed kernel)
//   dx       = dy2 * a,  dB[c] = sum_q dy2[q, c],  dA[c] = sum_q dy2[q, c] x[q, c]
//   dK[t]    = sum_p y[p + off_t]^T g[p]                   (B8)
//
// with t = 3 * ky + kx and off_t = (ky - 1, kx - 1). dA uses the ORIGINAL x.
//
// What bounds them on an H100: bytes, on the tensor cores. At the model's
// widths (Cin 48, Cout 12) each does 2*9*Cin*Cout = 10368 flops per pixel;
// B7 moves 240 bytes a pixel in f32 (reads x, writes out), B7' 432 (reads g
// and x, writes dx), B8 240 (reads x and g): 24-43 flops a byte, below the
// ridge of 3xTF32's 495/3 TFLOP/s against 3.35 TB/s (49 flops a byte). The
// TPU kernel put the 9 taps on one MXU matmul against a 128-lane padded
// operand; none of that carries over (no lane padding, no T matrix, no halo
// DMA).
//
// fw_kernel<T> (B7): an implicit GEMM on mma.sync, M = the 256 pixels of an
//   8 x 32 tile (warp w takes tile row w, two m16 fragments), N = 16 output
//   channels (Cout 12 padded: two n8 fragments), K = 9 taps x a slab of up
//   to 48 input channels (all of the dense layer's Cin, so x is read from
//   device memory once). Persistent blocks walk the tiles with a two-stage
//   cp.async ring, as B7' does: the next tile's (8+2) x (32+2) x window
//   loads while the current one computes. The affine is applied to the
//   staged window in place (affine_window, shared with B8), and A fragments
//   are read from it by im2col addressing (pixel + the tap's offset); the
//   kernel, staged once per block (transposed, and for f32 split), gives the
//   B fragments (stage_kernel, shared with B7'). f32 multiplies in 3xTF32
//   with the split made at fragment load (hi = v cut to TF32, lo the exact
//   rest: lo*hi + hi*lo + hi*hi); each 16-deep K step is summed from zero on
//   the tensor cores and the steps are added in f32 on the CUDA cores. bf16
//   multiplies bf16 x bf16 exactly (m16n8k16), chained in f32 as B1 and B7'
//   do. The f32 output tile is staged in shared memory and leaves in 16-byte
//   stores of whole pixel rows, the real Cout channels only (store_tile,
//   shared with B7'). The split is made at fragment load because a window
//   split once per tile into TF32 hi and lo takes 141 KB at Cin 48, room for
//   one stage and no ring; on the card that variant ran slower, and 16 warps
//   (one m16 fragment each) no faster than 8.
// dx_kernel<T> (B7'): an implicit GEMM on mma.sync, M = the 256 pixels of an
//   8 x 32 tile, N = the forward's Cin (all 48 in one block: g is staged once
//   per tile, with no zero slots), K = 9 taps x the forward's Cout (108).
//   f32 multiplies in 3xTF32 (v = hi + lo, each rounded to TF32; the sum
//   takes hi*hi + hi*lo + lo*hi in f32, about 2^-21 relative per product);
//   bf16 multiplies bf16 x bf16 exactly (m16n8k16), f32 accumulation. The
//   kernel is tap-reversed, transposed (and for f32 split) into shared
//   memory once per block; A fragments are read straight from the staged g
//   window per tap (the im2col is addressing only). Persistent blocks walk
//   the tiles with a two-stage cp.async ring: the next tile's g window and x
//   tile load while the current one computes. The epilogue works in the
//   fragment layout: dx = acc * a is written over the staged x tile (f32; a
//   separate f32 tile for bf16) and leaves in 16-byte stores of whole pixel
//   rows; each thread sums dB and dA over its pixels, a butterfly over the
//   warp's lanes and a warp-order sum give the tile's, added to the block's
//   running partial in tile order; reduce_kernel sums the blocks' partials
//   in block order. No atomics: dA and dB are the same from run to run.
//   wgmma adds nothing at N = 48 and K = 108 once the kernel is bytes-bound.
// dk_kernel<T> (B8): an implicit GEMM on mma.sync per pixel chunk, M = 9
//   taps x 48 input channels (432 rows; all of the dense layer's Cin, so x
//   and g are read from device memory once), N = 16 output channels (Cout
//   12 padded), K = the chunk's pixels. 18 warps, two per tap t owning its
//   48 rows (3 m16 tiles x 2 n8 tiles), one the top and one the bottom four
//   rows of every tile; their sums are added, top then bottom, at the end.
//   The block walks its chunk's 8 x 32 pixel tiles with a two-stage
//   cp.async ring, as B7' does: the next tile's (8+2) x (32+2) x window and
//   g tile load while the current one computes.
//   The affine is applied in shared memory (y = x * a + b rounded to x's
//   dtype, 0 outside the image: in place for f32, into an f32 window for
//   bf16, whose g goes to f32 too), and A fragments are read from the
//   window by im2col addressing (pixel + the tap's offset), B fragments
//   from the g tile. f32 multiplies in 3xTF32 (v = hi + lo, hi cut to TF32,
//   lo the exact rest, of which the tensor cores read TF32's bits: lo*hi +
//   hi*lo + hi*hi); bf16 values are exact in TF32, so one TF32 product.
//   Each 16-pixel step is summed from zero on the tensor cores and added in
//   f32 on the CUDA cores (their chained f32 accumulation does not round to
//   nearest). Each chunk writes one f32 partial; dk_reduce_kernel sums the
//   chunks in chunk order. No atomics: dK is the same from run to run.
// bf16 inputs are read as bf16, y is rounded to bf16 as the forward's
// operand is, and everything is computed and written in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;                 // output rows per tile
constexpr int TW = 32;                // output columns per tile
constexpr int RED_THREADS = 256;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// sums[k][c] = sum over n of part[k][n][c], n in a fixed order: block (c, k)
__global__ void __launch_bounds__(RED_THREADS)
reduce_kernel(const float* __restrict__ part, float* __restrict__ db, float* __restrict__ da,
              int n, int C) {
  __shared__ float s[RED_THREADS];
  const int c = blockIdx.x;
  const int kind = blockIdx.y;
  const float* p = part + (size_t)kind * n * C + c;
  float acc = 0.f;
  for (int k = threadIdx.x; k < n; k += RED_THREADS) acc += p[(size_t)k * C];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int step = RED_THREADS / 2; step > 0; step /= 2) {
    if (threadIdx.x < step) s[threadIdx.x] += s[threadIdx.x + step];
    __syncthreads();
  }
  if (threadIdx.x == 0) (kind == 0 ? db : da)[c] = s[0];
}

// ---------------------------------------------------------------------------
// Tensor-core and cp.async helpers.
// ---------------------------------------------------------------------------

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

constexpr int WIN_C = TW + 2;               // window columns
constexpr int WIN_PIX = (TH + 2) * WIN_C;   // 340 window pixels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (16, 8 or 4) from global src to shared dst; 0 bytes
// are read, and zeros written, when !ok
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool ok) {
  const uint32_t d = smem_u32(dst);
  const int n = ok ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the widest copy (16, 8 or 4 bytes) that divides every offset and length of
// a pixel-row copy, given their OR; 0: element by element (2-byte runs)
__device__ __forceinline__ int copy_bytes(unsigned m) {
  return (m & 15) == 0 ? 16 : (m & 7) == 0 ? 8 : (m & 3) == 0 ? 4 : 0;
}

__device__ __forceinline__ unsigned low_bits(const void* p) {
  return (unsigned)(reinterpret_cast<uintptr_t>(p) & 15);
}

// 3xTF32: v ~ hi + lo, each rounded to TF32 (10 mantissa bits, to nearest,
// ties away: cvt.rna); hi + lo keeps about 22 of v's 24 bits
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

constexpr uint32_t TF32_MASK = 0xffffe000u;  // sign, exponent and TF32's 10 mantissa bits

// hi = v cut to TF32's 10 mantissa bits, lo = v - hi (exact); the tensor
// cores read lo's TF32 bits
__device__ __forceinline__ void split_tf32_cut(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & TF32_MASK;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0.f);
}

template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// ---------------------------------------------------------------------------
// What B7, B7' and B8 share: the unit of a persistent block's work, the
// staged window, the affine, the staged kernel and the output tile's store.
// ---------------------------------------------------------------------------

// one unit of a block's work: (tile, output pass, input slab)
struct TileUnit {
  int b, r0, c0;   // image and tile origin
  int n0, nc;      // output channels [n0, n0 + nc)
  int cs0, gs, gp; // input channels [cs0, cs0 + gs), per-tap pitch gp
  bool first, last;  // first / last slab of the pass
  bool first_tile;   // the block's first tile
};

// unit u of block blockIdx.x, which walks tiles blockIdx.x + j gridDim.x;
// per tile n_pass * n_slab units, passes of npass of the N output channels,
// slabs of nslab of the G input channels
__device__ __forceinline__ TileUnit tile_unit(int u, int per_tile, int n_slab, int ntx, int nty,
                                              int N, int G, bool f32, int npass, int nslab) {
  TileUnit d;
  const int j = u / per_tile;
  const int tile = blockIdx.x + j * gridDim.x;
  const int rem = u - j * per_tile;
  const int pass = rem / n_slab;
  const int slab = rem - pass * n_slab;
  d.b = tile / (nty * ntx);
  const int t2 = tile - d.b * nty * ntx;
  d.r0 = (t2 / ntx) * TH;
  d.c0 = (t2 % ntx) * TW;
  d.n0 = pass * npass;
  d.nc = min(npass, N - d.n0);
  d.cs0 = slab * nslab;
  d.gs = min(nslab, G - d.cs0);
  d.gp = f32 ? d.gs : round_up(d.gs, 2);
  d.first = slab == 0;
  d.last = slab == n_slab - 1;
  d.first_tile = j == 0;
  return d;
}

// The (TH+2) x (TW+2) window of channels [ch0, ch0 + nc) of src (B,H,W,C)
// around the 8 x 32 tile at (b, r0, c0), pixel pitch `pitch` values, 0
// outside the image: by cp.async in the widest chunks that divide every
// offset; where none does, value by value, and channels [nc, fill) get 0.
template <typename T>
__device__ void stage_window(T* win, int pitch, int fill, const T* __restrict__ src, int b,
                             int r0, int c0, int H, int W, int C, int ch0, int nc, int nthreads) {
  constexpr int E = sizeof(T);
  const int cb = copy_bytes((nc * E) | (C * E) | (ch0 * E) | (pitch * E) | low_bits(src));
  if (cb) {
    const int cpp = nc * E / cb;
    for (int e = threadIdx.x; e < WIN_PIX * cpp; e += nthreads) {
      const int wp = e / cpp;
      const int part = e - wp * cpp;
      const int wr = wp / WIN_C;
      const int r = r0 - 1 + wr;
      const int c = c0 - 1 + wp - wr * WIN_C;
      const bool ok = r >= 0 && r < H && c >= 0 && c < W;
      const char* s = reinterpret_cast<const char*>(src);
      if (ok) s += ((((size_t)b * H + r) * W + c) * C + ch0) * E + part * cb;
      cp_async(reinterpret_cast<char*>(win) + (size_t)wp * pitch * E + part * cb, s, cb, ok);
    }
  } else {
    for (int e = threadIdx.x; e < WIN_PIX * fill; e += nthreads) {
      const int wp = e / fill;
      const int ch = e - wp * fill;
      const int wr = wp / WIN_C;
      const int r = r0 - 1 + wr;
      const int c = c0 - 1 + wp - wr * WIN_C;
      T v = zero_of<T>();
      if (ch < nc && r >= 0 && r < H && c >= 0 && c < W)
        v = src[(((size_t)b * H + r) * W + c) * C + ch0 + ch];
      win[(size_t)wp * pitch + ch] = v;
    }
  }
}

// y = x * a + b rounded to x's dtype, 0 outside the image and at channels
// [kc, 4 ceil(kc / 4)), over the window of the tile at (r0, c0): from the
// staged x (pitch px values of T) into y (pitch py values of Y, float or T:
// in place when y is the window), a group of 4 channels per thread and
// iteration (16 bytes of f32, 8 of bf16); a, b per channel in shared memory
template <typename T, typename Y>
__device__ void affine_window(const T* win, int px, Y* y, int py, const float* s_a,
                              const float* s_b, int kc, int r0, int c0, int H, int W,
                              int nthreads) {
  const int groups = (kc + 3) / 4;
  for (int e = threadIdx.x; e < WIN_PIX * groups; e += nthreads) {
    const int wp = e / groups;
    const int cg = (e - wp * groups) * 4;
    const int wr = wp / WIN_C;
    const int r = r0 - 1 + wr;
    const int c = c0 - 1 + wp - wr * WIN_C;
    const bool inside = r >= 0 && r < H && c >= 0 && c < W;
    float xv[4];
    if constexpr (sizeof(T) == 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(win + wp * px + cg);
      xv[0] = q4.x;
      xv[1] = q4.y;
      xv[2] = q4.z;
      xv[3] = q4.w;
    } else {
      const uint2 q2 = *reinterpret_cast<const uint2*>(win + wp * px + cg);
      xv[0] = __uint_as_float(q2.x << 16);
      xv[1] = __uint_as_float(q2.x & 0xffff0000u);
      xv[2] = __uint_as_float(q2.y << 16);
      xv[3] = __uint_as_float(q2.y & 0xffff0000u);
    }
    const float4 a4 = *reinterpret_cast<const float4*>(s_a + cg);
    const float4 b4 = *reinterpret_cast<const float4*>(s_b + cg);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = inside && cg + q < kc ? Num<T>::round(fmaf(xv[q], av[q], bv[q])) : 0.f;
    if constexpr (sizeof(Y) == 4) {
      *reinterpret_cast<float4*>(y + wp * py + cg) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      // v holds bf16 values: exact
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(y + wp * py + cg) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
}

// where stage_kernel finds the kernel and puts its B fragments
struct KStage {
  long long st;      // kmat's stride between taps,
  int sn, sc;        // output channels and input channels
  bool reverse;      // tap 8 - t (B7', the tap-reversed kernel)
  int n0, nc, nr;    // output channels [n0, n0 + nc), nr rows staged
  int c0, kc, cp;    // input channels [c0, c0 + kc), per-tap K pitch cp
  int kpad, kp, yp;  // K rows staged, row pitch, the window's pixel pitch
};

// The kernel as B fragments, transposed: kt[n * kp + k] for rows n < nr and
// K rows k = t * cp + c < kpad, the value kmat[tap * st + (n0 + n) * sn +
// (c0 + c) * sc] (tap t, or 8 - t if reverse), 0 past nc, kc and 9 * cp;
// f32 as its TF32 hi part (kt_hi) and lo part (kt_lo), hi cut to TF32 (CUT)
// or rounded to nearest. koff[k]: the window offset, at pixel pitch yp, of K
// row k from a pixel's tap-(0, 0) slot.
template <typename T, bool CUT>
__device__ void stage_kernel(unsigned char* kt_hi, unsigned char* kt_lo, int* koff,
                             const T* __restrict__ kmat, const KStage& s, int nthreads) {
  const int kk_n = 9 * s.cp;
  for (int e = threadIdx.x; e < s.nr * s.kpad; e += nthreads) {
    const int n = e / s.kpad;
    const int k = e - n * s.kpad;
    T v = zero_of<T>();
    if (n < s.nc && k < kk_n) {
      const int t = k / s.cp;
      const int c = k - t * s.cp;
      if (c < s.kc)
        v = kmat[(s.reverse ? 8 - t : t) * s.st + (size_t)(s.n0 + n) * s.sn +
                 (size_t)(s.c0 + c) * s.sc];
    }
    if constexpr (sizeof(T) == 4) {
      uint32_t hi, lo;
      if constexpr (CUT)
        split_tf32_cut(v, hi, lo);
      else
        split_tf32(v, hi, lo);
      reinterpret_cast<uint32_t*>(kt_hi)[n * s.kp + k] = hi;
      reinterpret_cast<uint32_t*>(kt_lo)[n * s.kp + k] = lo;
    } else {
      reinterpret_cast<T*>(kt_hi)[n * s.kp + k] = v;
    }
  }
  for (int k = threadIdx.x; k < s.kpad; k += nthreads) {
    int off = 0;
    if (k < kk_n) {
      const int t = k / s.cp;
      off = ((t / 3) * WIN_C + t % 3) * s.yp + k - t * s.cp;
    }
    koff[k] = off;
  }
}

// the f32 output tile (pixel tp of the 8 x 32 tile at tile[tp * pitch]) into
// channels [n0, n0 + nc) of dst (B,H,W,C): whole pixel rows, neighbouring
// threads on neighbouring 16 bytes where every offset allows
__device__ void store_tile(float* __restrict__ dst, const float* tile, int pitch,
                           const TileUnit& d, int H, int W, int C, int nthreads) {
  const int cb = copy_bytes((d.nc * 4) | (C * 4) | (d.n0 * 4) | low_bits(dst));
  if (cb == 16) {
    const int cpp = d.nc / 4;
    for (int e = threadIdx.x; e < TH * TW * cpp; e += nthreads) {
      const int tp = e / cpp;
      const int q = e - tp * cpp;
      const int rr = d.r0 + tp / TW;
      const int cc = d.c0 + tp % TW;
      if (rr < H && cc < W)
        *reinterpret_cast<float4*>(dst + (((size_t)d.b * H + rr) * W + cc) * C + d.n0 + 4 * q) =
            *reinterpret_cast<const float4*>(tile + tp * pitch + 4 * q);
    }
  } else {
    for (int e = threadIdx.x; e < TH * TW * d.nc; e += nthreads) {
      const int tp = e / d.nc;
      const int ch = e - tp * d.nc;
      const int rr = d.r0 + tp / TW;
      const int cc = d.c0 + tp % TW;
      if (rr < H && cc < W) dst[(((size_t)d.b * H + rr) * W + cc) * C + d.n0 + ch] =
          tile[tp * pitch + ch];
    }
  }
}

// ---------------------------------------------------------------------------
// B7 on the tensor cores: out = sum_t y[p + off_t] K_t as an implicit GEMM,
// M = pixels of an 8x32 tile, N = 16 output channels per pass, K = 9 taps x
// a slab of up to 48 input channels.
// ---------------------------------------------------------------------------

constexpr int FW_THREADS = 256;  // 8 warps; warp w computes tile row w
constexpr int FW_CB = 48;        // input channels per slab
constexpr int FW_NC = 16;        // output channels per pass: 2 n8 fragments
constexpr int FW_NF = FW_NC / 8;
constexpr int FW_YP_F32 = 52;    // window pixel pitch, f32 words and bf16 values: a
constexpr int FW_YP_BF16 = 56;   // fragment's 8 pixels x 4 words on 32 banks
constexpr int FW_OP = 24;        // pitch of a pixel's staged output: float2 stores of
                                 // a half warp on disjoint banks
static_assert(TH * 32 == FW_THREADS, "one warp per tile row");

// Dynamic shared memory of fw_kernel<T> for Cin input channels; byte
// offsets, every region 16-byte aligned.
struct FwLayout {
  int kpad;  // 9 * (the first slab's per-tap K pitch), rounded up to a 16-deep step
  int kp;    // row pitch of the transposed kernel (bank-conflict-free B loads)
  int kt_hi, kt_lo, koff, win, win_stage, outs, bytes;
};

__host__ __device__ inline FwLayout fw_layout(int Cin, int esize) {
  FwLayout L;
  const bool f32 = esize == 4;
  const int kc = Cin < FW_CB ? Cin : FW_CB;
  L.kpad = round_up(9 * (f32 ? kc : round_up(kc, 2)), 16);
  L.kp = L.kpad + (f32 ? 4 : 8);
  int o = 0;
  L.kt_hi = o;
  o += round_up(FW_NC * L.kp * esize, 16);
  L.kt_lo = o;
  if (f32) o += round_up(FW_NC * L.kp * 4, 16);
  L.koff = o;
  o += round_up(L.kpad * 4, 16);
  L.win_stage = round_up(WIN_PIX * (f32 ? FW_YP_F32 : FW_YP_BF16) * esize, 16);
  L.win = o;
  o += 2 * L.win_stage;
  L.outs = o;
  o += TH * TW * FW_OP * 4;
  L.bytes = o;
  return L;
}

// acc[mf][nf] (+)= A x K for tile row `warp`, pixels 16 mf + {gq, gq + 8}:
// A read from the affine'd window at pixel + the K row's offset (koff)
template <typename T>
__device__ __forceinline__ void fw_mma(float (&acc)[2][FW_NF][4], const T* win,
                                       const unsigned char* smem, const FwLayout& L,
                                       const TileUnit& d, int warp, int gq, int t4) {
  constexpr int YP = sizeof(T) == 4 ? FW_YP_F32 : FW_YP_BF16;
  const int* koff = reinterpret_cast<const int*>(smem + L.koff);
  const int kk_n = 9 * d.gp;
  const int steps = (kk_n + 15) / 16;
  const int base = (warp * WIN_C + gq) * YP;
  if constexpr (sizeof(T) == 4) {
    const uint32_t* kth = reinterpret_cast<const uint32_t*>(smem + L.kt_hi);
    const uint32_t* ktl = reinterpret_cast<const uint32_t*>(smem + L.kt_lo);
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      // one 16-deep step, summed from zero on the tensor cores
      float st[2][FW_NF][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < FW_NF; ++nf)
#pragma unroll
          for (int q = 0; q < 4; ++q) st[mf][nf][q] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k0 = s * 16 + h * 8 + t4;
        const int k1 = k0 + 4;
        const bool v0 = k0 < kk_n;
        const bool v1 = k1 < kk_n;
        const int o0 = koff[k0];
        const int o1 = koff[k1];
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const float* p = win + base + mf * 16 * YP;
          split_tf32_cut(v0 ? p[o0] : 0.f, ah[mf][0], al[mf][0]);
          split_tf32_cut(v0 ? p[8 * YP + o0] : 0.f, ah[mf][1], al[mf][1]);
          split_tf32_cut(v1 ? p[o1] : 0.f, ah[mf][2], al[mf][2]);
          split_tf32_cut(v1 ? p[8 * YP + o1] : 0.f, ah[mf][3], al[mf][3]);
        }
#pragma unroll
        for (int nf = 0; nf < FW_NF; ++nf) {
          const int row = (nf * 8 + gq) * L.kp;
          const uint32_t bh[2] = {kth[row + k0], kth[row + k1]};
          const uint32_t bl[2] = {ktl[row + k0], ktl[row + k1]};
#pragma unroll
          for (int mf = 0; mf < 2; ++mf) {
            mma_tf32(st[mf][nf], al[mf], bh);  // lo * hi
            mma_tf32(st[mf][nf], ah[mf], bl);  // hi * lo
            mma_tf32(st[mf][nf], ah[mf], bh);  // hi * hi
          }
        }
      }
      // ... and added to the sums on the CUDA cores, rounded to nearest
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < FW_NF; ++nf)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mf][nf][q] += st[mf][nf][q];
    }
  } else {
    const T* kt = reinterpret_cast<const T*>(smem + L.kt_hi);
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      const int k0 = s * 16 + 2 * t4;
      const int k1 = k0 + 8;
      const bool v0 = k0 < kk_n;
      const bool v1 = k1 < kk_n;
      const int o0 = koff[k0];
      const int o1 = koff[k1];
      uint32_t av[2][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        const T* p = win + base + mf * 16 * YP;
        av[mf][0] = v0 ? ld_u32(p + o0) : 0u;
        av[mf][1] = v0 ? ld_u32(p + 8 * YP + o0) : 0u;
        av[mf][2] = v1 ? ld_u32(p + o1) : 0u;
        av[mf][3] = v1 ? ld_u32(p + 8 * YP + o1) : 0u;
      }
#pragma unroll
      for (int nf = 0; nf < FW_NF; ++nf) {
        const int row = (nf * 8 + gq) * L.kp;
        const uint32_t bv[2] = {ld_u32(kt + row + k0), ld_u32(kt + row + k1)};
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) mma_bf16(acc[mf][nf], av[mf], bv);
      }
    }
  }
}

// B7: out (B,H,W,Cout) f32 = conv3x3(y, kmat), y = x * a + b rounded to x's
// dtype and 0 outside the image; x (B,H,W,Cin), kmat (3,3,Cin,Cout).
//
// Persistent: block j walks tiles j, j + gridDim.x, ...; per tile one unit
// per (16-channel output pass, 48-channel input slab), one unit for the
// dense layer's 48 -> 12. A ring of two stages: while a unit computes,
// cp.async brings the next unit's x window. The kernel (transposed, and for
// f32 split into TF32 hi and lo) and a, b are staged once per block when a
// tile has one unit, else per unit.
template <typename T>
__global__ void __launch_bounds__(FW_THREADS, 1)
fw_kernel(const T* __restrict__ x, const T* __restrict__ kmat, const float* __restrict__ a,
          const float* __restrict__ bvec, float* __restrict__ out, int B, int H, int W, int Cin,
          int Cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float s_a[FW_CB];
  __shared__ __align__(16) float s_b[FW_CB];
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int YP = F32 ? FW_YP_F32 : FW_YP_BF16;
  const FwLayout L = fw_layout(Cin, sizeof(T));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const int n_tiles = B * nty * ntx;
  const int n_slab = (Cin + FW_CB - 1) / FW_CB;
  const int per_tile = ((Cout + FW_NC - 1) / FW_NC) * n_slab;
  const int n_units = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * per_tile;
  const bool one_kernel = per_tile == 1;
  float* outs = reinterpret_cast<float*>(smem + L.outs);

  auto unit = [&](int u) {
    return tile_unit(u, per_tile, n_slab, ntx, nty, Cout, Cin, F32, FW_NC, FW_CB);
  };
  auto window = [&](int u) { return reinterpret_cast<T*>(smem + L.win + (u & 1) * L.win_stage); };
  // the unit's kernel slab as B fragments, and its a, b
  auto stage_unit = [&](const TileUnit& d) {
    const KStage ks = {(long long)Cin * Cout, 1, Cout, false, d.n0, d.nc, FW_NC,
                       d.cs0, d.gs, d.gp, L.kpad, L.kp, YP};
    stage_kernel<T, true>(smem + L.kt_hi, smem + L.kt_lo, reinterpret_cast<int*>(smem + L.koff),
                          kmat, ks, FW_THREADS);
    if (tid < FW_CB) {
      s_a[tid] = tid < d.gs ? a[d.cs0 + tid] : 0.f;
      s_b[tid] = tid < d.gs ? bvec[d.cs0 + tid] : 0.f;
    }
  };
  auto prefetch = [&](int u) {
    const TileUnit d = unit(u);
    stage_window(window(u), YP, d.gs, x, d.b, d.r0, d.c0, H, W, Cin, d.cs0, d.gs, FW_THREADS);
  };

  if (one_kernel) stage_unit(unit(0));
  prefetch(0);
  cp_async_commit();

  float acc[2][FW_NF][4];
  for (int u = 0; u < n_units; ++u) {
    const TileUnit d = unit(u);
    T* win = window(u);
    if (u + 1 < n_units) prefetch(u + 1);
    cp_async_commit();
    if (!one_kernel) stage_unit(d);
    cp_async_wait1();
    __syncthreads();  // unit u's window, the kernel, a and b are in place
    affine_window<T, T>(win, YP, win, YP, s_a, s_b, d.gs, d.r0, d.c0, H, W, FW_THREADS);
    __syncthreads();  // y is in place
    if (d.first) {
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < FW_NF; ++nf)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mf][nf][q] = 0.f;
    }
    fw_mma<T>(acc, win, smem, L, d, warp, gq, t4);
    if (d.last) {
      // the output tile from the fragment layout: this thread owns pixels
      // 16 mf + 8 h + gq of tile row `warp` and channels 8 nf + 2 t4 + {0, 1}
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nf = 0; nf < FW_NF; ++nf)
            *reinterpret_cast<float2*>(outs + (warp * TW + mf * 16 + h * 8 + gq) * FW_OP +
                                       nf * 8 + 2 * t4) =
                make_float2(acc[mf][nf][2 * h], acc[mf][nf][2 * h + 1]);
      __syncthreads();
      store_tile(out, outs, FW_OP, d, H, W, Cout, FW_THREADS);
    }
    __syncthreads();  // everyone is done with stage u & 1 and the output tile
  }
}

// ---------------------------------------------------------------------------
// B7' on the tensor cores: dy2 = sum_t g[q + off_t] K'_t as an implicit GEMM,
// M = pixels of an 8x32 tile, N = the forward's Cin (48 per pass), K = 9 taps
// x the forward's Cout (16 g channels per slab).
// ---------------------------------------------------------------------------

constexpr int DX_THREADS = 256;               // 8 warps; warp w computes tile row w
constexpr int DX_NC = 48;                     // output channels per pass: 6 n8 fragments
constexpr int DX_NF = DX_NC / 8;
constexpr int DX_GS = 16;                     // g channels per staged slab
constexpr int DX_XP = DX_NC + 8;              // pitch of a pixel's x / dx row: float2
                                              // accesses of a half warp on disjoint banks
static_assert(TH * 32 == DX_THREADS, "one warp per tile row");
static_assert(TW == 32, "a warp's two m16 fragments cover one tile row");

// Dynamic shared memory of dx_kernel<T>, from the g channel count G and
// sizeof(T); byte offsets, every region 16-byte aligned.
struct DxLayout {
  int gp;        // channels per tap of the first slab (K pitch and window pitch)
  int kpad;      // 9 * gp rounded up to the mma depth (8 tf32, 16 bf16)
  int kp;        // row pitch of the transposed kernel (bank-conflict-free B loads)
  int kt_hi, kt_lo, koff, win, xt, dxs, red;
  int win_stage, xt_stage, bytes;
};

__host__ __device__ inline DxLayout dx_layout(int G, int esize) {
  DxLayout L;
  const bool f32 = esize == 4;
  const int gs = G < DX_GS ? G : DX_GS;
  L.gp = f32 ? gs : round_up(gs, 2);
  L.kpad = round_up(9 * L.gp, f32 ? 8 : 16);
  L.kp = L.kpad + (f32 ? 4 : 8);
  int o = 0;
  L.kt_hi = o;
  o += round_up(DX_NC * L.kp * esize, 16);
  L.kt_lo = o;
  if (f32) o += round_up(DX_NC * L.kp * 4, 16);
  L.koff = o;
  o += round_up(L.kpad * 4, 16);
  L.win_stage = round_up(WIN_PIX * L.gp * esize, 16);
  L.win = o;
  o += 2 * L.win_stage;
  L.xt_stage = round_up(TH * TW * DX_XP * esize, 16);
  L.xt = o;
  o += 2 * L.xt_stage;
  L.dxs = o;  // f32: dx is written in place over the x tile
  if (!f32) o += TH * TW * DX_XP * 4;
  L.red = o;
  o += 8 * 2 * DX_NC * 4;
  L.bytes = o;
  return L;
}

// one unit of B7': (tile, 48-channel output pass, 16-channel g slab)
__device__ __forceinline__ TileUnit dx_unit(int u, int per_tile, int n_slab, int ntx, int nty,
                                            int N, int G, bool f32) {
  return tile_unit(u, per_tile, n_slab, ntx, nty, N, G, f32, DX_NC, DX_GS);
}

// x's channels [n0, n0 + nc) at the tile's pixels, 0 outside the image
template <typename T>
__device__ void dx_stage_xtile(T* xt, const T* __restrict__ x, const TileUnit& d, int H, int W,
                               int N) {
  constexpr int E = sizeof(T);
  const int cb = copy_bytes((d.nc * E) | (N * E) | (d.n0 * E) | low_bits(x));
  if (cb) {
    const int cpp = d.nc * E / cb;
    for (int e = threadIdx.x; e < TH * TW * cpp; e += DX_THREADS) {
      const int tp = e / cpp;
      const int part = e - tp * cpp;
      const int r = d.r0 + tp / TW;
      const int c = d.c0 + tp % TW;
      const bool ok = r < H && c < W;
      const char* src = reinterpret_cast<const char*>(x);
      if (ok) src += ((((size_t)d.b * H + r) * W + c) * N + d.n0) * E + part * cb;
      cp_async(reinterpret_cast<char*>(xt) + ((size_t)tp * DX_XP) * E + part * cb, src, cb, ok);
    }
  } else {
    for (int e = threadIdx.x; e < TH * TW * d.nc; e += DX_THREADS) {
      const int tp = e / d.nc;
      const int ch = e - tp * d.nc;
      const int r = d.r0 + tp / TW;
      const int c = d.c0 + tp % TW;
      xt[tp * DX_XP + ch] =
          (r < H && c < W) ? x[(((size_t)d.b * H + r) * W + c) * N + d.n0 + ch] : zero_of<T>();
    }
  }
}

// K'[k = t * gp + c][n] = K[8 - t][n0 + n][cs0 + c] for kmat (3,3,N,G),
// stored transposed (row n, k contiguous) with koff; f32 as its TF32 hi and
// lo parts, rounded to nearest
template <typename T>
__device__ void dx_stage_kernel(unsigned char* smem, const DxLayout& L,
                                const T* __restrict__ kmat, const TileUnit& d, int N, int G) {
  const KStage ks = {(long long)N * G, G, 1, true, d.n0, d.nc, DX_NC, d.cs0, d.gs, d.gp,
                     L.kpad, L.kp, d.gp};
  stage_kernel<T, false>(smem + L.kt_hi, smem + L.kt_lo, reinterpret_cast<int*>(smem + L.koff),
                         kmat, ks, DX_THREADS);
}

// acc[mf][nf] += A (tile row `warp`, pixels 16 mf + {g, g + 8}) x K'
template <typename T>
__device__ __forceinline__ void dx_mma(float (&acc)[2][DX_NF][4], const T* win,
                                       const unsigned char* smem, const DxLayout& L,
                                       const TileUnit& d, int warp, int gq, int t4) {
  const int* koff = reinterpret_cast<const int*>(smem + L.koff);
  const int kk_n = 9 * d.gp;
  const int base = (warp * WIN_C + gq) * d.gp;
  if constexpr (sizeof(T) == 4) {
    const uint32_t* kth = reinterpret_cast<const uint32_t*>(smem + L.kt_hi);
    const uint32_t* ktl = reinterpret_cast<const uint32_t*>(smem + L.kt_lo);
    const int steps = (kk_n + 7) / 8;
#pragma unroll 2
    for (int kk = 0; kk < steps; ++kk) {
      const int k0 = kk * 8 + t4;
      const int k1 = k0 + 4;
      const bool v0 = k0 < kk_n;
      const bool v1 = k1 < kk_n;
      const int o0 = koff[k0];
      const int o1 = koff[k1];
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        const float* p = win + base + mf * 16 * d.gp;
        split_tf32(v0 ? p[o0] : 0.f, ah[mf][0], al[mf][0]);
        split_tf32(v0 ? p[8 * d.gp + o0] : 0.f, ah[mf][1], al[mf][1]);
        split_tf32(v1 ? p[o1] : 0.f, ah[mf][2], al[mf][2]);
        split_tf32(v1 ? p[8 * d.gp + o1] : 0.f, ah[mf][3], al[mf][3]);
      }
#pragma unroll
      for (int nf = 0; nf < DX_NF; ++nf) {
        const int row = (nf * 8 + gq) * L.kp;
        const uint32_t bh[2] = {kth[row + k0], kth[row + k1]};
        const uint32_t bl[2] = {ktl[row + k0], ktl[row + k1]};
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          mma_tf32(acc[mf][nf], al[mf], bh);
          mma_tf32(acc[mf][nf], ah[mf], bl);
          mma_tf32(acc[mf][nf], ah[mf], bh);
        }
      }
    }
  } else {
    const T* kt = reinterpret_cast<const T*>(smem + L.kt_hi);
    const int steps = (kk_n + 15) / 16;
#pragma unroll 2
    for (int kk = 0; kk < steps; ++kk) {
      const int k0 = kk * 16 + 2 * t4;
      const int k1 = k0 + 8;
      const bool v0 = k0 < kk_n;
      const bool v1 = k1 < kk_n;
      const int o0 = koff[k0];
      const int o1 = koff[k1];
      uint32_t av[2][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        const T* p = win + base + mf * 16 * d.gp;
        av[mf][0] = v0 ? ld_u32(p + o0) : 0u;
        av[mf][1] = v0 ? ld_u32(p + 8 * d.gp + o0) : 0u;
        av[mf][2] = v1 ? ld_u32(p + o1) : 0u;
        av[mf][3] = v1 ? ld_u32(p + 8 * d.gp + o1) : 0u;
      }
#pragma unroll
      for (int nf = 0; nf < DX_NF; ++nf) {
        const int row = (nf * 8 + gq) * L.kp;
        const uint32_t bv[2] = {ld_u32(kt + row + k0), ld_u32(kt + row + k1)};
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) mma_bf16(acc[mf][nf], av[mf], bv);
      }
    }
  }
}

// B7': dx (B,H,W,N) f32 = dy2 * a with dy2 the conv of g (B,H,W,G) with the
// tap-reversed, transposed forward kernel kmat (3,3,N,G); partial
// (2, gridDim.x, N): row 0 each block's dB, row 1 its dA (with the original
// x), summed over the block's pixels in a fixed order.
//
// Persistent: block j walks tiles j, j + gridDim.x, ...; per tile one unit
// per (48-channel output pass, 16-channel g slab), one unit for the dense
// layer's 48 <- 12. A ring of two stages: while a unit computes, cp.async
// brings the next unit's g window and x tile. The kernel (transposed, and
// for f32 split into TF32 hi and lo) is staged once per block when a tile has
// one unit, else per unit.
template <typename T>
__global__ void __launch_bounds__(DX_THREADS, 1)
dx_kernel(const T* __restrict__ g, const T* __restrict__ kmat, const float* __restrict__ a,
          const T* __restrict__ xorig, float* __restrict__ dx, float* __restrict__ partial,
          int B, int H, int W, int N, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool F32 = sizeof(T) == 4;
  const DxLayout L = dx_layout(G, sizeof(T));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const int n_tiles = B * nty * ntx;
  const int n_slab = (G + DX_GS - 1) / DX_GS;
  const int per_tile = ((N + DX_NC - 1) / DX_NC) * n_slab;
  const int n_units = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * per_tile;
  const bool one_kernel = per_tile == 1;
  float* red = reinterpret_cast<float*>(smem + L.red);

  auto prefetch = [&](int u) {
    const TileUnit d = dx_unit(u, per_tile, n_slab, ntx, nty, N, G, F32);
    T* win = reinterpret_cast<T*>(smem + L.win + (u & 1) * L.win_stage);
    stage_window(win, d.gp, d.gp, g, d.b, d.r0, d.c0, H, W, G, d.cs0, d.gs, DX_THREADS);
    if (d.last) dx_stage_xtile(reinterpret_cast<T*>(smem + L.xt + (u & 1) * L.xt_stage), xorig, d,
                               H, W, N);
  };

  if (one_kernel) dx_stage_kernel(smem, L, kmat, dx_unit(0, 1, 1, ntx, nty, N, G, F32), N, G);
  prefetch(0);
  cp_async_commit();

  float acc[2][DX_NF][4];
  for (int u = 0; u < n_units; ++u) {
    const int s = u & 1;
    const TileUnit d = dx_unit(u, per_tile, n_slab, ntx, nty, N, G, F32);
    if (u + 1 < n_units) prefetch(u + 1);
    cp_async_commit();
    if (!one_kernel) dx_stage_kernel(smem, L, kmat, d, N, G);
    cp_async_wait1();
    __syncthreads();
    if (d.first) {
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < DX_NF; ++nf)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mf][nf][q] = 0.f;
    }
    dx_mma<T>(acc, reinterpret_cast<const T*>(smem + L.win + s * L.win_stage), smem, L, d, warp,
              gq, t4);
    if (d.last) {
      // epilogue in the fragment layout: this thread owns pixels 16 mf + 8 h
      // + gq of tile row `warp` and channels 8 nf + 2 t4 + {0, 1}
      const T* xt = reinterpret_cast<const T*>(smem + L.xt + s * L.xt_stage);
      float* dxs = F32 ? reinterpret_cast<float*>(smem + L.xt + s * L.xt_stage)
                       : reinterpret_cast<float*>(smem + L.dxs);
      const int r = d.r0 + warp;
      float sa[DX_NF][2], sb[DX_NF][2], av[DX_NF][2];
#pragma unroll
      for (int nf = 0; nf < DX_NF; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nf * 8 + 2 * t4 + e;
          av[nf][e] = n < d.nc ? a[d.n0 + n] : 0.f;
          sa[nf][e] = sb[nf][e] = 0.f;
        }
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tx = mf * 16 + h * 8 + gq;
          const bool ok = r < H && d.c0 + tx < W;
          const int tp = warp * TW + tx;
#pragma unroll
          for (int nf = 0; nf < DX_NF; ++nf) {
            const int n = nf * 8 + 2 * t4;
            const float v0 = acc[mf][nf][2 * h];
            const float v1 = acc[mf][nf][2 * h + 1];
            if (n + 1 < d.nc) {
              float x0, x1;
              if constexpr (F32) {
                const float2 x2 = *reinterpret_cast<const float2*>(xt + tp * DX_XP + n);
                x0 = x2.x;
                x1 = x2.y;
              } else {
                const __nv_bfloat162 x2 =
                    *reinterpret_cast<const __nv_bfloat162*>(xt + tp * DX_XP + n);
                x0 = __low2float(x2);
                x1 = __high2float(x2);
              }
              if (ok) {
                sb[nf][0] += v0;
                sb[nf][1] += v1;
                sa[nf][0] = fmaf(v0, x0, sa[nf][0]);
                sa[nf][1] = fmaf(v1, x1, sa[nf][1]);
              }
              *reinterpret_cast<float2*>(dxs + tp * DX_XP + n) =
                  make_float2(v0 * av[nf][0], v1 * av[nf][1]);
            } else if (n < d.nc) {
              const float x0 = Num<T>::load(xt[tp * DX_XP + n]);
              if (ok) {
                sb[nf][0] += v0;
                sa[nf][0] = fmaf(v0, x0, sa[nf][0]);
              }
              dxs[tp * DX_XP + n] = v0 * av[nf][0];
            }
          }
        }
      // dB, dA over the warp's pixels: a butterfly over the 8 lanes of one
      // t4, the same order in every run; lanes gq == 0 keep the sums
#pragma unroll
      for (int nf = 0; nf < DX_NF; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            sb[nf][e] += __shfl_xor_sync(0xffffffffu, sb[nf][e], off);
            sa[nf][e] += __shfl_xor_sync(0xffffffffu, sa[nf][e], off);
          }
      if (gq == 0) {
#pragma unroll
        for (int nf = 0; nf < DX_NF; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nf * 8 + 2 * t4 + e;
            red[(warp * 2) * DX_NC + n] = sb[nf][e];
            red[(warp * 2 + 1) * DX_NC + n] = sa[nf][e];
          }
      }
      __syncthreads();
      // dx in whole pixel rows: neighbouring threads, neighbouring 16 bytes
      store_tile(dx, dxs, DX_XP, d, H, W, N, DX_THREADS);
      // the block's running dB, dA: the warps' sums in warp order, added to
      // the block's previous tiles in tile order
      if (tid < 2 * DX_NC) {
        const int kind = tid / DX_NC;
        const int n = tid - kind * DX_NC;
        if (n < d.nc) {
          float s8 = 0.f;
          for (int w = 0; w < 8; ++w) s8 += red[(w * 2 + kind) * DX_NC + n];
          float* dst = partial + ((size_t)kind * gridDim.x + blockIdx.x) * N + d.n0 + n;
          *dst = d.first_tile ? s8 : *dst + s8;
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// B8 on the tensor cores: dK[t] = sum_p y[p + off_t]^T g[p] as an implicit
// GEMM, M = 9 taps x 48 input channels, N = 16 output channels, K = pixels.
// ---------------------------------------------------------------------------

constexpr int DK_CB = 48;                    // input channels per block: 3 m16 tiles a tap
constexpr int DK_MT = DK_CB / 16;
constexpr int DK_NC = 16;                    // output channels per block: 2 n8 tiles
constexpr int DK_WPT = 2;                    // warps per tap, each half of a tile's rows
constexpr int DK_THREADS = 9 * DK_WPT * 32;
constexpr int DK_YP = 56;                    // window pixel pitch (f32 words, bf16 values):
                                             // a fragment's 4 pixels x 8 channels on 32 banks
constexpr int DK_GP = 24;                    // f32 g pixel pitch, the same for 4 x 8
constexpr int DK_GRAW = 16;                  // bf16 g pixel pitch as loaded
static_assert(TW % 16 == 0, "a 16-pixel step lies in one tile row");

// Dynamic shared memory of dk_kernel<T>, byte offsets, 16-byte aligned: a
// ring of two stages of the x window and g tile as loaded (x's dtype), then,
// for bf16, the f32 window and g tile the products read (for f32 they are
// the ring's stage itself, the affine applied in place)
struct DkLayout {
  int win, gt, stage;  // offsets in a stage, stage bytes
  int ywin, yg;        // the f32 window and g tile (bf16 only)
  int bytes;
};

__host__ __device__ inline DkLayout dk_layout(int esize) {
  DkLayout L;
  const int gp = esize == 4 ? DK_GP : DK_GRAW;
  L.win = 0;
  L.gt = round_up(WIN_PIX * DK_YP * esize, 16);
  L.stage = L.gt + round_up(TH * TW * gp * esize, 16);
  int o = 2 * L.stage;
  L.ywin = esize == 4 ? 0 : o;
  if (esize != 4) o += WIN_PIX * DK_YP * 4;
  L.yg = esize == 4 ? L.gt : o;
  if (esize != 4) o += TH * TW * DK_GP * 4;
  L.bytes = o;
  return L;
}

// partial[chunk][t][c][o] = sum over the chunk's tiles of y[p + off_t, c] g[p, o];
// block (chunk, cin block, cout block): channels [48 y, +48) and [16 z, +16)
template <typename T>
__global__ void __launch_bounds__(DK_THREADS, 1)
dk_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ a,
          const float* __restrict__ bvec, float* __restrict__ partial, int B, int H, int W,
          int Cin, int Cout, int tiles_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float s_a[DK_CB];
  __shared__ __align__(16) float s_b[DK_CB];
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int E = sizeof(T);
  constexpr int GPR = F32 ? DK_GP : DK_GRAW;  // g pitch of the ring, in values
  const DkLayout L = dk_layout(E);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = warp % 9;        // this warp's tap
  const int half = warp / 9;     // and its half of a tile's rows
  const int ky = t / 3;
  const int kx = t - ky * 3;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int c0 = blockIdx.y * DK_CB;
  const int kc = min(DK_CB, Cin - c0);
  const int o0 = blockIdx.z * DK_NC;
  const int nc = min(DK_NC, Cout - o0);
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const int n_tiles = B * nty * ntx;
  const int first = blockIdx.x * tiles_per_chunk;
  const int n_units = min(n_tiles, first + tiles_per_chunk) - first;

  // zeros everywhere the loads never write (channels past kc and nc, g's
  // padding), kept for the whole block
  for (int e = tid; e < L.bytes / 16; e += DK_THREADS)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  if (tid < DK_CB) {
    s_a[tid] = tid < kc ? a[c0 + tid] : 0.f;
    s_b[tid] = tid < kc ? bvec[c0 + tid] : 0.f;
  }
  __syncthreads();

  const int gcb = copy_bytes((nc * E) | (Cout * E) | (o0 * E) | low_bits(g));
  auto tile_origin = [&](int tile, int& b, int& r0, int& cc0) {
    b = tile / (nty * ntx);
    const int rem = tile - b * nty * ntx;
    r0 = (rem / ntx) * TH;
    cc0 = (rem % ntx) * TW;
  };
  // tile `tile`'s x window and g tile into ring stage st, as x's dtype
  auto prefetch = [&](int tile, int st) {
    int b, r0, cc0;
    tile_origin(tile, b, r0, cc0);
    T* win = reinterpret_cast<T*>(smem + st * L.stage + L.win);
    T* gt = reinterpret_cast<T*>(smem + st * L.stage + L.gt);
    stage_window(win, DK_YP, kc, x, b, r0, cc0, H, W, Cin, c0, kc, DK_THREADS);
    if (gcb) {
      const int cpp = nc * E / gcb;
      for (int e = tid; e < TH * TW * cpp; e += DK_THREADS) {
        const int tp = e / cpp;
        const int part = e - tp * cpp;
        const int r = r0 + tp / TW;
        const int c = cc0 + tp % TW;
        const bool ok = r < H && c < W;
        const char* src = reinterpret_cast<const char*>(g);
        if (ok) src += ((((size_t)b * H + r) * W + c) * Cout + o0) * E + part * gcb;
        cp_async(reinterpret_cast<char*>(gt) + (size_t)tp * GPR * E + part * gcb, src, gcb, ok);
      }
    } else {
      for (int e = tid; e < TH * TW * nc; e += DK_THREADS) {
        const int tp = e / nc;
        const int ch = e - tp * nc;
        const int r = r0 + tp / TW;
        const int c = cc0 + tp % TW;
        gt[tp * GPR + ch] =
            (r < H && c < W) ? g[(((size_t)b * H + r) * W + c) * Cout + o0 + ch] : zero_of<T>();
      }
    }
  };

  float acc[DK_MT][2][4];
#pragma unroll
  for (int mt = 0; mt < DK_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  if (n_units > 0) prefetch(first, 0);
  cp_async_commit();
  for (int u = 0; u < n_units; ++u) {
    const int st = u & 1;
    if (u + 1 < n_units) prefetch(first + u + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // tile u landed for every thread
    // y = x * a + b rounded to x's dtype, 0 outside the image (f32 in
    // place; bf16 into the f32 window), and for bf16 g to f32
    {
      int b, r0, cc0;
      tile_origin(first + u, b, r0, cc0);
      const T* win = reinterpret_cast<const T*>(smem + st * L.stage + L.win);
      float* y = reinterpret_cast<float*>(smem + (F32 ? st * L.stage + L.win : L.ywin));
      affine_window<T, float>(win, DK_YP, y, DK_YP, s_a, s_b, kc, r0, cc0, H, W, DK_THREADS);
      if constexpr (!F32) {
        const T* gt = reinterpret_cast<const T*>(smem + st * L.stage + L.gt);
        float* yg = reinterpret_cast<float*>(smem + L.yg);
        for (int e = tid; e < TH * TW * DK_NC; e += DK_THREADS) {
          const int tp = e / DK_NC;
          const int ch = e - tp * DK_NC;
          yg[tp * DK_GP + ch] = Num<T>::load(gt[tp * DK_GRAW + ch]);
        }
      }
    }
    __syncthreads();  // the f32 window and g tile are ready
    const float* y = reinterpret_cast<const float*>(smem + (F32 ? st * L.stage + L.win : L.ywin));
    const float* gs = reinterpret_cast<const float*>(smem + (F32 ? st * L.stage + L.gt : L.yg));
    constexpr int STEPS = TH * TW / 16 / DK_WPT;  // 16-pixel steps of this warp's half
#pragma unroll 2
    for (int s = half * STEPS; s < (half + 1) * STEPS; ++s) {
      const int pr = s / (TW / 16);
      const int pc0 = (s - pr * (TW / 16)) * 16;
      // the step's B fragments (g at its pixels t4, t4 + 4 of each 8)
      uint32_t bh[2][2][2], bl[2][2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* gb = gs + (pr * TW + pc0 + 8 * h + t4) * DK_GP + gq;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float v0 = gb[nt * 8], v1 = gb[4 * DK_GP + nt * 8];
          if constexpr (F32) {
            split_tf32_cut(v0, bh[h][nt][0], bl[h][nt][0]);
            split_tf32_cut(v1, bh[h][nt][1], bl[h][nt][1]);
          } else {
            bh[h][nt][0] = __float_as_uint(v0);
            bh[h][nt][1] = __float_as_uint(v1);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < DK_MT; ++mt) {
        // one 16-pixel step of m16 tile mt, summed from zero on the tensor cores
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* ya =
              y + ((pr + ky) * (TW + 2) + pc0 + 8 * h + t4 + kx) * DK_YP + mt * 16 + gq;
          const float v[4] = {ya[0], ya[8], ya[4 * DK_YP], ya[4 * DK_YP + 8]};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if constexpr (F32) {
              split_tf32_cut(v[q], ah[q], al[q]);
            } else {
              ah[q] = __float_as_uint(v[q]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            if constexpr (F32) {
              mma_tf32(d[nt], al, bh[h][nt]);  // lo * hi
              mma_tf32(d[nt], ah, bl[h][nt]);  // hi * lo
            }
            mma_tf32(d[nt], ah, bh[h][nt]);    // hi * hi (bf16: exact in TF32)
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += d[nt][q];
      }
    }
    __syncthreads();  // everyone is done with stage st before it is refilled
  }

  // the bottom half's sums through shared memory (the ring is free), added
  // to the top half's: the same order in every run
  float* red = reinterpret_cast<float*>(smem);
  constexpr int ACC = DK_MT * 2 * 4;
  if (half == 1) {
#pragma unroll
    for (int mt = 0; mt < DK_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) red[((t * ACC) + (mt * 2 + nt) * 4 + q) * 32 + lane] = acc[mt][nt][q];
  }
  __syncthreads();
  if (half == 1) return;
  // the chunk's partial: rows (t, c0 + 16 mt + gq (+8)), columns o0 + 8 nt + 2 t4 (+1)
  float* dst = partial + ((size_t)blockIdx.x * 9 + t) * Cin * Cout;
#pragma unroll
  for (int mt = 0; mt < DK_MT; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ch = mt * 16 + gq + 8 * (q >> 1);
      if (ch >= kc) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int o = nt * 8 + 2 * t4 + (q & 1);
        if (o < nc)
          dst[(size_t)(c0 + ch) * Cout + o0 + o] =
              acc[mt][nt][q] + red[((t * ACC) + (mt * 2 + nt) * 4 + q) * 32 + lane];
      }
    }
}

// dk[v] = sum over chunks of partial[chunk][v], in chunk order
__global__ void dk_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dk,
                                 int n_values, int n_chunks) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_values) return;
  float s = 0.f;
  for (int k = 0; k < n_chunks; ++k) s += partial[(size_t)k * n_values + v];
  dk[v] = s;
}

template <typename T>
int fwd(const void* x, const void* a, const void* b, const void* k, void* out, int B, int H,
        int W, int Cin, int Cout, int n_blocks, void* stream) {
  const long long n_tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || n_blocks < 1 || n_blocks > n_tiles)
    return (int)cudaErrorInvalidValue;
  const FwLayout L = fw_layout(Cin, (int)sizeof(T));
  const cudaError_t e =
      cudaFuncSetAttribute(fw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e != cudaSuccess) return (int)e;
  fw_kernel<T><<<n_blocks, FW_THREADS, L.bytes, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)k, (const float*)a, (const float*)b, (float*)out, B, H, W, Cin,
      Cout);
  return (int)cudaGetLastError();
}

template <typename T>
int dx(const void* g, const void* x, const void* a, const void* k, void* dxp, void* partial,
       void* da, void* db, int B, int H, int W, int Cin, int Cout, int n_blocks, void* stream) {
  const long long n_tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || n_blocks < 1 || n_blocks > n_tiles)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // the transposed conv: reads g's Cout channels, writes Cin
  const DxLayout L = dx_layout(Cout, (int)sizeof(T));
  const cudaError_t e = cudaFuncSetAttribute(
      dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e != cudaSuccess) return (int)e;
  dx_kernel<T><<<n_blocks, DX_THREADS, L.bytes, st>>>((const T*)g, (const T*)k, (const float*)a,
                                                      (const T*)x, (float*)dxp, (float*)partial,
                                                      B, H, W, Cin, Cout);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  reduce_kernel<<<dim3(Cin, 2), RED_THREADS, 0, st>>>((const float*)partial, (float*)db,
                                                      (float*)da, n_blocks, Cin);
  return (int)cudaGetLastError();
}

template <typename T>
int dk(const void* x, const void* g, const void* a, const void* b, void* partial, void* dkp,
       int B, int H, int W, int Cin, int Cout, int tiles_per_chunk, int n_chunks, void* stream) {
  const long long n_tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || tiles_per_chunk < 1 || n_chunks < 1 ||
      (long long)(n_chunks - 1) * tiles_per_chunk >= n_tiles ||
      (long long)n_chunks * tiles_per_chunk < n_tiles || n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const DkLayout L = dk_layout((int)sizeof(T));
  const cudaError_t e =
      cudaFuncSetAttribute(dk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_chunks, (Cin + DK_CB - 1) / DK_CB, (Cout + DK_NC - 1) / DK_NC);
  dk_kernel<T><<<grid, DK_THREADS, L.bytes, st>>>((const T*)x, (const T*)g, (const float*)a,
                                                  (const float*)b, (float*)partial, B, H, W, Cin,
                                                  Cout, tiles_per_chunk);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int n_values = 9 * Cin * Cout;
  dk_reduce_kernel<<<(n_values + 255) / 256, 256, 0, st>>>((const float*)partial, (float*)dkp,
                                                           n_values, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Tensors contiguous on the device of `stream`;
// x, g and k in the named dtype, a and b f32 (Cin), every output f32.
// Each returns the first nonzero cudaGetLastError() of its launches.
//
// B7: x (B,H,W,Cin), k (3,3,Cin,Cout) -> out (B,H,W,Cout); n_blocks (at
// most the number of 8x32 tiles) persistent blocks.
extern "C" int dense_conv_fwd_f32(const void* x, const void* a, const void* b, const void* k,
                                  void* out, int B, int H, int W, int Cin, int Cout,
                                  int n_blocks, void* stream) {
  return fwd<float>(x, a, b, k, out, B, H, W, Cin, Cout, n_blocks, stream);
}

extern "C" int dense_conv_fwd_bf16(const void* x, const void* a, const void* b, const void* k,
                                   void* out, int B, int H, int W, int Cin, int Cout,
                                   int n_blocks, void* stream) {
  return fwd<__nv_bfloat16>(x, a, b, k, out, B, H, W, Cin, Cout, n_blocks, stream);
}

// B7': g (B,H,W,Cout), x (B,H,W,Cin), k (3,3,Cin,Cout) -> dx (B,H,W,Cin),
// da, db (Cin); n_blocks (at most the number of 8x32 tiles) persistent
// blocks; partial is an f32 scratch of 2 * n_blocks * Cin.
extern "C" int dense_conv_dx_f32(const void* g, const void* x, const void* a, const void* k,
                                 void* dx_out, void* partial, void* da, void* db, int B, int H,
                                 int W, int Cin, int Cout, int n_blocks, void* stream) {
  return dx<float>(g, x, a, k, dx_out, partial, da, db, B, H, W, Cin, Cout, n_blocks, stream);
}

extern "C" int dense_conv_dx_bf16(const void* g, const void* x, const void* a, const void* k,
                                  void* dx_out, void* partial, void* da, void* db, int B, int H,
                                  int W, int Cin, int Cout, int n_blocks, void* stream) {
  return dx<__nv_bfloat16>(g, x, a, k, dx_out, partial, da, db, B, H, W, Cin, Cout, n_blocks,
                           stream);
}

// B8: x (B,H,W,Cin), g (B,H,W,Cout) -> dk (3,3,Cin,Cout); partial is an f32
// scratch of n_chunks * 9 * Cin * Cout, chunk z the 8x32 tiles
// [z tiles_per_chunk, +tiles_per_chunk) (the last may be shorter, none empty).
extern "C" int dense_conv_dk_f32(const void* x, const void* g, const void* a, const void* b,
                                 void* partial, void* dk_out, int B, int H, int W, int Cin,
                                 int Cout, int tiles_per_chunk, int n_chunks, void* stream) {
  return dk<float>(x, g, a, b, partial, dk_out, B, H, W, Cin, Cout, tiles_per_chunk, n_chunks,
                   stream);
}

extern "C" int dense_conv_dk_bf16(const void* x, const void* g, const void* a, const void* b,
                                  void* partial, void* dk_out, int B, int H, int W, int Cin,
                                  int Cout, int tiles_per_chunk, int n_chunks, void* stream) {
  return dk<__nv_bfloat16>(x, g, a, b, partial, dk_out, B, H, W, Cin, Cout, tiles_per_chunk,
                           n_chunks, stream);
}
