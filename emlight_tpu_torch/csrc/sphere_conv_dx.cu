// Sphere conv input gradient (dx) at stride 2 — hand-written CUDA C++ for
// sm_90a (H100).
//
// Replaces emlight_tpu/nn/sphere_conv_vjp.py::_dx_kernel_s2 (the Pallas TPU
// kernel B5, launched by _dx_pallas); stride 1 (B3) is
// csrc/sphere_conv_dx_s1.cu. The forward reads
//
//   out[i, j] += w(i,t,k,j) * x[rows[i,t,k], (stride*j + s[i,t,k]) mod W] @ K_t
//
// so its transpose, for the cotangent g (B, Ho, Wo, Cout), is
//
//   U[t][i][j]  = g[i][j] @ K_t^T                                  (Cin wide)
//   dx[r][col]  = sum over the triples (i,t,k) with rows[i,t,k] == r, and the
//                 output column j with (stride*j + s) mod W == col, of
//                 w(i,t,k,j) * U[t][i][j]
//
// The triples of each input row r are the port's inverse_tables(h, w,
// stride) (nn/sphere_conv_vjp.py): at most 64 slots (out_row, tap, shift,
// w0, jdev), padded slots with w0 == 0 pointing at an in-range row.
//
// Two kernels, launched back to back on one stream:
// 1. u_product: U = g @ K^T for all 9 taps as one tiled f32 product of
//    (B*Ho*Wo, Cout) by (Cout, 9*Cin), register micro-tiles over shared-memory
//    slabs like the forward, written to an f32 scratch (B, 9, Ho, Wo, Cin)
//    that the wrapper allocates. It is bound by operations (2*9*Cin*Cout
//    flops per output pixel, as the forward). The TPU kernel kept U for an
//    8-row window in VMEM; on the card that window (9 x 4 rows x 256 x Cin
//    f32 at 128x256) does not fit in shared memory, so U goes through device
//    memory, where the 50 MB L2 holds the few rows a block of dx rows reads.
// 2. dx_gather: one block per (input row, batch, chunk of the row's W*Cin
//    values). It stages the row's table slots in shared memory and, for each
//    slot, every thread adds w * U[tap][out_row][j] to 8 register
//    accumulators, with j the output column whose shifted read lands on the
//    thread's input column: only when (col - s) mod W is even, j = that / 2
//    (the template keeps the stride, S = 2 the one built). This writes even and odd
//    columns in place, so no parity planes are needed. Slots with w0 == 0 are
//    skipped rather than multiplied (0 * inf would poison dx), and the dead
//    column j == jdev adds nothing. It is a gather: no atomics, and each dx
//    value is summed in slot order, the same from run to run.
// bf16 inputs are read as bf16 and computed in f32; U and dx are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // pixels per block (product)
constexpr int BN = 64;   // (tap, cin) columns per block (product)
constexpr int BK = 16;   // cout slab
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int NTHREADS = (BM / TM) * (BN / TN);  // 256
constexpr int ELEMS = 8;                          // dx values per thread (gather)
constexpr int MAX_FANIN = 64;

static_assert(BM == BN, "one staging loop fills both slabs");

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

// U[b, t, p, c] = sum_o g[b, p, o] * K[t, c, o]; M = B*Po rows, N = 9*Cin cols
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
u_product_kernel(const T* __restrict__ g, const T* __restrict__ kmat,
                 float* __restrict__ u, int M, int Po, int Cin, int Cout) {
  __shared__ float a_tile[BK][BM + 1];
  __shared__ float b_tile[BK][BN + 1];
  const int N = 9 * Cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  for (int k0 = 0; k0 < Cout; k0 += BK) {
    // both operands are contiguous along cout: the 16 lanes of a slab row
    // read 16 neighbouring values
#pragma unroll
    for (int r = 0; r < BM * BK / NTHREADS; ++r) {
      const int e = tid + r * NTHREADS;
      const int kk = e % BK;
      const int mm = e / BK;
      const int o = k0 + kk;
      const int m = m0 + mm;
      a_tile[kk][mm] = (m < M && o < Cout) ? Num<T>::load(g[(size_t)m * Cout + o]) : 0.f;
      const int n = n0 + mm;
      b_tile[kk][mm] = (n < N && o < Cout) ? Num<T>::load(kmat[(size_t)n * Cout + o]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = a_tile[kk][ty + m * (BM / TM)];
#pragma unroll
      for (int n = 0; n < TN; ++n) bv[n] = b_tile[kk][tx + n * (BN / TN)];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], bv[n], acc[m][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int mg = m0 + ty + m * (BM / TM);
    if (mg >= M) continue;
    const int b = mg / Po;
    const int p = mg - b * Po;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int ng = n0 + tx + n * (BN / TN);
      if (ng >= N) continue;
      const int t = ng / Cin;
      const int c = ng - t * Cin;
      u[(((size_t)b * 9 + t) * Po + p) * Cin + c] = acc[m][n];
    }
  }
}

template <int S>
__global__ void __launch_bounds__(NTHREADS)
dx_gather_kernel(const float* __restrict__ u, const int* __restrict__ orow,
                 const int* __restrict__ tap, const int* __restrict__ shift,
                 const float* __restrict__ w0, const int* __restrict__ jdev,
                 float* __restrict__ dx, int H, int W, int Cin, int fanin) {
  __shared__ int s_base[MAX_FANIN];   // (tap * Ho + out_row) * Wo
  __shared__ int s_shift[MAX_FANIN];
  __shared__ int s_jdev[MAX_FANIN];
  __shared__ float s_w0[MAX_FANIN];

  const int Ho = H / S;
  const int Wo = W / S;
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const int row_len = W * Cin;
  const int e0 = blockIdx.z * (NTHREADS * ELEMS);
  const int tid = threadIdx.x;

  for (int m = tid; m < fanin; m += NTHREADS) {
    const int g = r * fanin + m;
    s_base[m] = (tap[g] * Ho + orow[g]) * Wo;
    s_shift[m] = shift[g];
    s_jdev[m] = jdev[g];
    s_w0[m] = w0[g];
  }
  __syncthreads();

  int col[ELEMS], ch[ELEMS];
  float acc[ELEMS];
#pragma unroll
  for (int q = 0; q < ELEMS; ++q) {
    const int e = e0 + tid + q * NTHREADS;
    col[q] = e < row_len ? e / Cin : -1;
    ch[q] = e - (e / Cin) * Cin;
    acc[q] = 0.f;
  }

  const float* ub = u + (size_t)b * 9 * Ho * Wo * Cin;
  for (int m = 0; m < fanin; ++m) {
    const float wm = s_w0[m];
    if (wm == 0.f) continue;  // padded slot: never read, never multiplied
    const int base = s_base[m];
    const int s = s_shift[m];
    const int jd = s_jdev[m];
#pragma unroll
    for (int q = 0; q < ELEMS; ++q) {
      if (col[q] < 0) continue;
      int d = col[q] - s;
      if (d < 0) d += W;
      if (S == 2 && (d & 1)) continue;
      const int j = d / S;
      if (j == jd) continue;
      acc[q] = fmaf(wm, ub[(size_t)(base + j) * Cin + ch[q]], acc[q]);
    }
  }

  float* dxr = dx + ((size_t)b * H + r) * row_len;
#pragma unroll
  for (int q = 0; q < ELEMS; ++q) {
    const int e = e0 + tid + q * NTHREADS;
    if (e < row_len) dxr[e] = acc[q];
  }
}

template <typename T>
int launch(const void* g, const void* kmat, void* u, const void* orow, const void* tap,
           const void* shift, const void* w0, const void* jdev, void* dx, int B, int H,
           int W, int Cin, int Cout, int stride, int fanin, void* stream) {
  if (stride != 2 || fanin > MAX_FANIN || fanin < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int Ho = H / stride, Wo = W / stride;
  const int M = B * Ho * Wo;
  const dim3 pgrid((M + BM - 1) / BM, (9 * Cin + BN - 1) / BN);
  u_product_kernel<T><<<pgrid, NTHREADS, 0, st>>>((const T*)g, (const T*)kmat, (float*)u, M,
                                                  Ho * Wo, Cin, Cout);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const dim3 ggrid(H, B, (W * Cin + NTHREADS * ELEMS - 1) / (NTHREADS * ELEMS));
  dx_gather_kernel<2><<<ggrid, NTHREADS, 0, st>>>(
      (const float*)u, (const int*)orow, (const int*)tap, (const int*)shift,
      (const float*)w0, (const int*)jdev, (float*)dx, H, W, Cin, fanin);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. g (B,H/stride,W/stride,Cout) and kmat
// (9,Cin,Cout) in the named dtype; u an f32 scratch of B*9*(H/stride)*
// (W/stride)*Cin values; inverse tables (H,fanin) int32/f32; dx (B,H,W,Cin)
// f32, every value written. All contiguous on the device of `stream`.
// Returns the first nonzero cudaGetLastError() of the two launches.
extern "C" int sphere_conv_dx_f32(const void* g, const void* kmat, void* u, const void* orow,
                                  const void* tap, const void* shift, const void* w0,
                                  const void* jdev, void* dx, int B, int H, int W, int Cin,
                                  int Cout, int stride, int fanin, void* stream) {
  return launch<float>(g, kmat, u, orow, tap, shift, w0, jdev, dx, B, H, W, Cin, Cout, stride,
                       fanin, stream);
}

extern "C" int sphere_conv_dx_bf16(const void* g, const void* kmat, void* u, const void* orow,
                                   const void* tap, const void* shift, const void* w0,
                                   const void* jdev, void* dx, int B, int H, int W, int Cin,
                                   int Cout, int stride, int fanin, void* stream) {
  return launch<__nv_bfloat16>(g, kmat, u, orow, tap, shift, w0, jdev, dx, B, H, W, Cin, Cout,
                               stride, fanin, stream);
}
