// Sphere conv input gradient (dx) at stride 1 on the small maps —
// hand-written CUDA C++ for sm_90a (H100).
//
// Replaces emlight_tpu/nn/sphere_conv_vjp.py::_dx_kernel_s1 (the Pallas TPU
// kernel B6, launched by _dx_pallas for the maps of fewer than 2048 pixels;
// the port routes the maps below UMAJOR_MIN_PIXELS, nn/sphere_conv_kernel.py,
// to it). It computes what that kernel computes:
//
//   U[p, t, c]   = sum_o g[p, o] K_t[c, o]          (f32, p a flat pixel)
//   dx[r][col]   = sum over the slots m of input row r (the port's
//                  inverse_tables: out_row i, tap t, shift s, weight w0, dead
//                  column jdev), in slot order, of
//                  w0 * U[(i, (col - s) mod W), t],  skipped where
//                  (col - s) mod W == jdev or w0 == 0
//
// What bounds it on an H100: operations, 2 * 9 * Cin * Cout flops per
// pixel, on the tensor cores. On the small maps (4x8 to 16x32: 256 to 8192
// flat pixels at the model's batches) the channels are wide (Cin 128-1024,
// Cout 3-2048), so the work is few pixels times many channels. The TPU
// kernel recomputed a U row for every slot that reads it.
//
// What this design does about it: U is computed once, as one GEMM on the
// tensor cores, and gathered by a second kernel.
// - u_gemm_kernel: M = the B*H*W flat pixels (64 per block), N = 9 * Cin
//   (the rows of kmat (9, Cin, Cout), 128 per block), K = Cout. Both
//   operands have K contiguous (g's rows, kmat's rows), so the 32 channels
//   of a K stage come by cp.async in 16-byte chunks into a 3-stage ring
//   (plain loads where Cout is not a multiple of the chunk: Cout = 3).
//   8 warps, each 32 pixels x 32 of N, run mma.sync: f32 in
//   3xTF32 (v = hi + lo, hi cut to TF32, lo the exact rest, of which the
//   tensor cores read TF32's bits: lo*hi + hi*lo + hi*hi), bf16 as bf16 x
//   bf16. Each 16-deep K step is summed from zero on the tensor cores and
//   added in f32 on the CUDA cores (their chained f32 accumulation does not
//   round to nearest). U is written in f32, as the reference keeps it.
//   Where the tiles alone give fewer than about 2 blocks per SM (the
//   128 -> 2048 convs on the 4x8 and 8x16 maps), K is cut into n_split
//   ranges of whole stages, each writing its own U partial.
// - dx_gather_kernel: per (image, input row, 256 (column, 4-channel chunk)
//   items) the row's slots from shared memory; per live slot the U chunk
//   (the partials summed in split order), times w0, added in slot order.
// Padded slots (w0 == 0) and the dead column are skipped, never
// multiplied: an inf in g reaches no dx value through them. No atomics:
// every value is summed in one fixed order, the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // flat pixels per block
constexpr int BN = 128;        // rows of kmat (tap, input channel) per block
constexpr int BK = 32;         // Cout channels per stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N
constexpr int MI = BM / 32;    // m16 tiles of a warp (32 pixels)
constexpr int WN = BN / 4;     // a warp's width along N
constexpr int NJ = WN / 8;     // and its n8 tiles
constexpr int MAX_FANIN = 64;
constexpr int GATHER_THREADS = 256;

constexpr uint32_t TF32_MASK = 0xffffe000u;  // sign, exponent and TF32's 10 mantissa bits

// the ring's row pitch in elements: 16 bytes of padding puts the 8 rows a
// fragment load reads on distinct banks
template <typename T>
struct Ring {
  static constexpr int PITCH = BK + 16 / (int)sizeof(T);
  static constexpr int A_ELEMS = BM * PITCH;
  static constexpr int STAGE_ELEMS = (BM + BN) * PITCH;
  static constexpr int BYTES = STAGES * STAGE_ELEMS * (int)sizeof(T);
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
};

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst; zeros written, nothing read, if !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0.f);
}

template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// rows [r0, r0 + rows) of a (n_rows, K) row-major operand, K channels
// [k0, k_end) of stage k0, into a ring tile of PITCH-element rows; zeros past
// n_rows and k_end. VEC: by cp.async in 16-byte chunks (K a multiple of the
// chunk, 16-byte aligned rows), else element by element.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int r0, int rows,
                                           int n_rows, int K, int k0, int k_end) {
  using R = Ring<T>;
  if constexpr (VEC) {
    constexpr int CPR = BK / R::VEC;  // chunks per row
    for (int e = threadIdx.x; e < rows * CPR; e += THREADS) {
      const int row = e / CPR;
      const int q = e - row * CPR;
      const int k = k0 + q * R::VEC;
      const bool ok = r0 + row < n_rows && k < k_end;
      cp_async16(dst + row * R::PITCH + q * R::VEC,
                 ok ? (const void*)(src + (size_t)(r0 + row) * K + k) : (const void*)src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * BK; e += THREADS) {
      const int row = e / BK;
      const int q = e - row * BK;
      const int k = k0 + q;
      dst[row * R::PITCH + q] =
          (r0 + row < n_rows && k < k_end) ? src[(size_t)(r0 + row) * K + k] : zero_of<T>();
    }
  }
}

// the 32-bit word of a ring tile at (row, k): f32 the value, bf16 the pair
// k, k + 1
template <typename T>
__device__ __forceinline__ uint32_t ld_word(const T* tile, int row, int k) {
  return *reinterpret_cast<const uint32_t*>(tile + row * Ring<T>::PITCH + k);
}

// U partial (split z of blockIdx.z): u[z][p][n] = sum over the split's K
// range of g[p][o] * kmat[n][o]; g (P, Cout), kmat (N, Cout) with N = 9 Cin.
// Grid: x = n tile (fastest: the blocks of one m tile share its g rows in
// L2), y = m tile, z = split; `per` channels of K per split (whole stages).
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
u_gemm_kernel(const T* __restrict__ g, const T* __restrict__ kmat, float* __restrict__ u, int P,
              int N, int Cout, int per) {
  using R = Ring<T>;
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 32-pixel half of the block
  const int wn = warp & 3;   // quarter of the block's N
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * per;
  const int k_end = min(Cout, k_begin + per);
  const int n_stages = (k_end - k_begin + BK - 1) / BK;

  auto load_stage = [&](int s) {
    T* st = ring + (s % STAGES) * R::STAGE_ELEMS;
    const int k0 = k_begin + s * BK;
    stage_rows<T, VEC>(st, g, m0, BM, P, Cout, k0, k_end);
    stage_rows<T, VEC>(st + R::A_ELEMS, kmat, n0, BN, N, Cout, k0, k_end);
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed for every thread; stage s - 1 is read
    if (s + STAGES - 1 < n_stages) load_stage(s + STAGES - 1);
    cp_async_commit();
    const T* a_t = ring + (s % STAGES) * R::STAGE_ELEMS + (wm * MI * 16) * R::PITCH;
    const T* b_t = ring + (s % STAGES) * R::STAGE_ELEMS + R::A_ELEMS + (wn * WN) * R::PITCH;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // one 16-deep K step, summed from zero on the tensor cores
      float d[MI][NJ][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) d[i][j][r] = 0.f;
      if constexpr (F32) {
#pragma unroll
        for (int k8 = kk; k8 < kk + 16; k8 += 8) {
          uint32_t ah[MI][4], al[MI][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const int row = i * 16 + gq;
            split_tf32(__uint_as_float(ld_word(a_t, row, k8 + t4)), ah[i][0], al[i][0]);
            split_tf32(__uint_as_float(ld_word(a_t, row + 8, k8 + t4)), ah[i][1], al[i][1]);
            split_tf32(__uint_as_float(ld_word(a_t, row, k8 + t4 + 4)), ah[i][2], al[i][2]);
            split_tf32(__uint_as_float(ld_word(a_t, row + 8, k8 + t4 + 4)), ah[i][3], al[i][3]);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int row = j * 8 + gq;
            split_tf32(__uint_as_float(ld_word(b_t, row, k8 + t4)), bh[j][0], bl[j][0]);
            split_tf32(__uint_as_float(ld_word(b_t, row, k8 + t4 + 4)), bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              mma_tf32(d[i][j], al[i], bh[j]);  // lo * hi
              mma_tf32(d[i][j], ah[i], bl[j]);  // hi * lo
              mma_tf32(d[i][j], ah[i], bh[j]);  // hi * hi
            }
        }
      } else {
        uint32_t a[MI][4], b[NJ][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int row = i * 16 + gq;
          a[i][0] = ld_word(a_t, row, kk + 2 * t4);
          a[i][1] = ld_word(a_t, row + 8, kk + 2 * t4);
          a[i][2] = ld_word(a_t, row, kk + 8 + 2 * t4);
          a[i][3] = ld_word(a_t, row + 8, kk + 8 + 2 * t4);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int row = j * 8 + gq;
          b[j][0] = ld_word(b_t, row, kk + 2 * t4);
          b[j][1] = ld_word(b_t, row, kk + 8 + 2 * t4);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_bf16(d[i][j], a[i], b[j]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += d[i][j][r];
    }
  }

  // epilogue: pixels m0 + 32 wm + 16 i + gq (+8), rows of N n0 + WN wn + 8 j + 2 t4 (+1)
  float* uz = u + (size_t)blockIdx.z * P * N;
  const bool pair = N % 2 == 0;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + wm * MI * 16 + i * 16 + gq + 8 * h;
      if (p >= P) continue;
      float* row = uz + (size_t)p * N;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + wn * WN + j * 8 + 2 * t4;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pair && n < N) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          if (n < N) row[n] = v0;
          if (n + 1 < N) row[n + 1] = v1;
        }
      }
    }
}

// dx (B, H, W, Cin) from the U partials u (n_split, B*H*W, 9, Cin): block
// (x, r, b) takes items [256 x, +256) of input row r of image b, an item a
// (column, 4-channel chunk) pair; per live slot of row r, in slot order,
// w0 * U (the partials summed in split order) at the slot's pixel and tap.
template <bool VEC4>
__global__ void __launch_bounds__(GATHER_THREADS)
dx_gather_kernel(const float* __restrict__ u, const int* __restrict__ orow,
                 const int* __restrict__ tap, const int* __restrict__ shift,
                 const float* __restrict__ w0, const int* __restrict__ jdev,
                 float* __restrict__ dx, int H, int W, int Cin, int fanin, int n_split) {
  __shared__ int s_row[MAX_FANIN];
  __shared__ int s_tap[MAX_FANIN];
  __shared__ int s_shift[MAX_FANIN];
  __shared__ int s_jdev[MAX_FANIN];
  __shared__ float s_w0[MAX_FANIN];
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  for (int m = threadIdx.x; m < fanin; m += GATHER_THREADS) {
    const int idx = r * fanin + m;
    s_row[m] = orow[idx];
    s_tap[m] = tap[idx];
    s_shift[m] = shift[idx];
    s_jdev[m] = jdev[idx];
    s_w0[m] = w0[idx];
  }
  __syncthreads();

  const int c4n = (Cin + 3) / 4;
  const int item = blockIdx.x * GATHER_THREADS + threadIdx.x;
  const int col = item / c4n;
  if (col >= W) return;
  const int c = (item - col * c4n) * 4;
  const size_t split_stride = (size_t)gridDim.z * H * W * 9 * Cin;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int m = 0; m < fanin; ++m) {
    const float wm = s_w0[m];
    if (wm == 0.f) continue;  // a padded slot
    int j = col - s_shift[m];
    if (j < 0) j += W;
    if (j == s_jdev[m]) continue;  // grid_sample's zero pad: adds nothing
    const float* src = u + ((((size_t)b * H + s_row[m]) * W + j) * 9 + s_tap[m]) * Cin + c;
    float v[4];
    if constexpr (VEC4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(src));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
      for (int z = 1; z < n_split; ++z) {
        const float4 q2 = __ldg(reinterpret_cast<const float4*>(src + z * split_stride));
        v[0] += q2.x;
        v[1] += q2.y;
        v[2] += q2.z;
        v[3] += q2.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = 0.f;
        if (c + e < Cin) {
          v[e] = __ldg(src + e);
          for (int z = 1; z < n_split; ++z) v[e] += __ldg(src + z * split_stride + e);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(wm, v[e]));
  }
  float* dst = dx + (((size_t)b * H + r) * W + col) * Cin + c;
  if constexpr (VEC4) {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < Cin) dst[e] = acc[e];
  }
}

template <typename T, bool VEC>
int launch_gemm(const void* g, const void* kmat, void* u, int P, int N, int Cout, int per,
                int n_split, cudaStream_t st) {
  const int smem = Ring<T>::BYTES;
  const cudaError_t e =
      cudaFuncSetAttribute(u_gemm_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (P + BM - 1) / BM, n_split);
  u_gemm_kernel<T, VEC><<<grid, THREADS, smem, st>>>((const T*)g, (const T*)kmat, (float*)u, P, N,
                                                     Cout, per);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* g, const void* kmat, const void* orow, const void* tap, const void* shift,
           const void* w0, const void* jdev, void* u, void* dx, int B, int H, int W, int Cin,
           int Cout, int fanin, int per, int n_split, void* stream) {
  const long long P = (long long)B * H * W;
  const long long N = 9LL * Cin;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || fanin < 1 || fanin > MAX_FANIN ||
      per < 1 || per % BK || n_split < 1 || n_split > 65535 ||
      (long long)(n_split - 1) * per >= Cout || (P + BM - 1) / BM > 65535 ||
      N >= 0x7fffffffLL || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = Cout % Ring<T>::VEC == 0 && ((reinterpret_cast<uintptr_t>(g) |
                                                  reinterpret_cast<uintptr_t>(kmat)) & 15) == 0;
  const int rc = vec ? launch_gemm<T, true>(g, kmat, u, (int)P, (int)N, Cout, per, n_split, st)
                     : launch_gemm<T, false>(g, kmat, u, (int)P, (int)N, Cout, per, n_split, st);
  if (rc) return rc;
  const int c4n = (Cin + 3) / 4;
  const dim3 grid((unsigned)((W * c4n + GATHER_THREADS - 1) / GATHER_THREADS), H, B);
  if (Cin % 4 == 0 && (reinterpret_cast<uintptr_t>(dx) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(u) & 15) == 0)
    dx_gather_kernel<true><<<grid, GATHER_THREADS, 0, st>>>(
        (const float*)u, (const int*)orow, (const int*)tap, (const int*)shift, (const float*)w0,
        (const int*)jdev, (float*)dx, H, W, Cin, fanin, n_split);
  else
    dx_gather_kernel<false><<<grid, GATHER_THREADS, 0, st>>>(
        (const float*)u, (const int*)orow, (const int*)tap, (const int*)shift, (const float*)w0,
        (const int*)jdev, (float*)dx, H, W, Cin, fanin, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. g (B,H,W,Cout) and kmat (9,Cin,Cout) in the
// named dtype; inverse tables (H,fanin) int32 / f32 (w0); u an f32 scratch
// of n_split * B*H*W * 9*Cin values (the U partials, split z over Cout
// channels [z per, (z + 1) per), per a multiple of 32); dx (B,H,W,Cin) f32,
// every value written. The split comes from the wrapper
// (nn/sphere_conv_kernel.py::triple_tiles). All contiguous on the device of
// `stream`. Returns the first nonzero cudaGetLastError() of the launches.
extern "C" int sphere_conv_dx_triple_f32(const void* g, const void* kmat, const void* orow,
                                         const void* tap, const void* shift, const void* w0,
                                         const void* jdev, void* u, void* dx, int B, int H, int W,
                                         int Cin, int Cout, int fanin, int per, int n_split,
                                         void* stream) {
  return launch<float>(g, kmat, orow, tap, shift, w0, jdev, u, dx, B, H, W, Cin, Cout, fanin, per,
                       n_split, stream);
}

extern "C" int sphere_conv_dx_triple_bf16(const void* g, const void* kmat, const void* orow,
                                          const void* tap, const void* shift, const void* w0,
                                          const void* jdev, void* u, void* dx, int B, int H,
                                          int W, int Cin, int Cout, int fanin, int per,
                                          int n_split, void* stream) {
  return launch<__nv_bfloat16>(g, kmat, orow, tap, shift, w0, jdev, u, dx, B, H, W, Cin, Cout,
                               fanin, per, n_split, stream);
}
