// Sphere conv kernel gradient (dK), strides 1 and 2 — hand-written CUDA C++
// for sm_90a (H100).
//
// Replaces emlight_tpu/nn/sphere_conv_vjp.py::_dk_kernel (the Pallas TPU
// kernel B4, launched by _dk_pallas). For the input x (B, H, W, Cin) and the
// cotangent g (B, Ho, Wo, Cout) of a stride-s sphere conv:
//
//   dK[t, c, o] = sum_{b, i, j} S_t[b, i, j, c] * g[b, i, j, o]
//   S_t[b,i,j,c] = sum_{k<4} w(i,t,k,j) * x[b, rows[i,t,k], (s*j + shift[i,t,k]) mod W, c]
//
// with the forward's structured tables (rows, shift, w0, jdev), so S_t is
// exactly the operand the forward kernel stages. The JAX package takes the
// XLA gather formulation at stride 2 (_bwd); this kernel serves both strides.
//
// What bounds it on an H100: operations, 2*9*Cin*Cout flops per output
// pixel as the forward, reduced over B*Ho*Wo pixels into a small
// (9, Cin, Cout) result. The TPU kernel carried one dK across its whole
// sequential grid; blocks on the card run in no order, so the pixel axis is
// cut into chunks:
// 1. dk_partial: one block per (cin tile of 64, cout tile of 64, tap, pixel
//    chunk). For each slab of 16 pixels it stages the sampled S_t tile
//    (16 pixels x 64 input channels; the 4 weighted reads, circular shift and
//    dead column applied on the way in, as the forward does) beside the g
//    tile (16 pixels x 64 output channels) in shared memory, and every thread
//    accumulates a 4x4 register micro-tile of dK. It writes an f32 partial
//    per chunk.
// 2. dk_reduce: sums the partials of each dK value in chunk order.
// No atomics: the result is the same from run to run. The chunk count
// (chosen by the wrapper) gives about 4 blocks per SM when cin*cout is small.
// bf16 inputs are read as bf16, S_t is rounded to bf16 as the forward's
// staged operand is, and everything is computed in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // input channels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // pixels per staged slab
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int NTHREADS = (BM / TM) * (BN / TN);  // 256
constexpr int CH_PER_THREAD = BM * BK / NTHREADS;  // 4 staged channels per thread

static_assert(NTHREADS % BK == 0 && NTHREADS / BK == 16, "one pixel per 16 threads");

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

template <typename T, int S>
__global__ void __launch_bounds__(NTHREADS)
dk_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const int* __restrict__ rows, const int* __restrict__ shifts,
                  const float* __restrict__ w0, const int* __restrict__ jdev,
                  float* __restrict__ partial, int B, int H, int W, int Cin, int Cout,
                  int chunk) {
  __shared__ float s_tile[BK][BM + 4];
  __shared__ float g_tile[BK][BN + 4];

  const int Ho = H / S;
  const int Wo = W / S;
  const int Po = Ho * Wo;
  const int n_ct = (Cin + BM - 1) / BM;
  const int c0 = (blockIdx.x % n_ct) * BM;
  const int o0 = (blockIdx.x / n_ct) * BN;
  const int t = blockIdx.y;
  const int q_begin = blockIdx.z * chunk;
  const int q_end = min(q_begin + chunk, B * Po);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // output channels tx + 16n
  const int ty = tid / (BN / TN);  // input channels ty + 16m

  // staging of S_t: pixel pp = tid / 16 of the slab, channels cc + 16r
  const int pp = tid / 16;
  const int cc = tid % 16;

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  for (int q0 = q_begin; q0 < q_end; q0 += BK) {
    {
      const int q = q0 + pp;
      float v[CH_PER_THREAD];
#pragma unroll
      for (int r = 0; r < CH_PER_THREAD; ++r) v[r] = 0.f;
      if (q < q_end) {
        const int b = q / Po;
        const int p = q - b * Po;
        const int i = p / Wo;
        const int j = p - i * Wo;
        const T* xb = x + (size_t)b * H * W * Cin;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = (i * 9 + t) * 4 + k;
          const float wq = (j == jdev[e]) ? 0.f : w0[e];
          int col = S * j + shifts[e];
          if (col >= W) col -= W;
          const T* src = xb + ((size_t)rows[e] * W + col) * Cin;
#pragma unroll
          for (int r = 0; r < CH_PER_THREAD; ++r) {
            const int c = c0 + cc + 16 * r;
            if (c < Cin) v[r] += wq * Num<T>::load(src[c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < CH_PER_THREAD; ++r) s_tile[pp][cc + 16 * r] = Num<T>::round(v[r]);
    }
#pragma unroll
    for (int r = 0; r < BN * BK / NTHREADS; ++r) {
      const int e = tid + r * NTHREADS;
      const int oo = e % BN;
      const int kk = e / BN;
      const int q = q0 + kk;
      const int o = o0 + oo;
      g_tile[kk][oo] = (q < q_end && o < Cout) ? Num<T>::load(g[(size_t)q * Cout + o]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = s_tile[kk][ty + m * (BM / TM)];
#pragma unroll
      for (int n = 0; n < TN; ++n) bv[n] = g_tile[kk][tx + n * (BN / TN)];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], bv[n], acc[m][n]);
    }
    __syncthreads();
  }

  float* part = partial + ((size_t)blockIdx.z * 9 + t) * Cin * Cout;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int c = c0 + ty + m * (BM / TM);
    if (c >= Cin) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int o = o0 + tx + n * (BN / TN);
      if (o < Cout) part[(size_t)c * Cout + o] = acc[m][n];
    }
  }
}

__global__ void dk_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dk,
                                 int n, int n_chunks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int z = 0; z < n_chunks; ++z) s += partial[(size_t)z * n + idx];
  dk[idx] = s;
}

template <typename T>
int launch(const void* x, const void* g, const void* rows, const void* shifts, const void* w0,
           const void* jdev, void* partial, void* dk, int B, int H, int W, int Cin, int Cout,
           int stride, int chunk, int n_chunks, void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(((Cin + BM - 1) / BM) * ((Cout + BN - 1) / BN), 9, n_chunks);
  if (stride == 1) {
    dk_partial_kernel<T, 1><<<grid, NTHREADS, 0, st>>>(
        (const T*)x, (const T*)g, (const int*)rows, (const int*)shifts, (const float*)w0,
        (const int*)jdev, (float*)partial, B, H, W, Cin, Cout, chunk);
  } else {
    dk_partial_kernel<T, 2><<<grid, NTHREADS, 0, st>>>(
        (const T*)x, (const T*)g, (const int*)rows, (const int*)shifts, (const float*)w0,
        (const int*)jdev, (float*)partial, B, H, W, Cin, Cout, chunk);
  }
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int n = 9 * Cin * Cout;
  dk_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>((const float*)partial, (float*)dk, n,
                                                   n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. x (B,H,W,Cin) and g (B,H/stride,W/stride,Cout)
// in the named dtype; forward tables (H/stride,9,4) int32/f32; partial an f32
// scratch of n_chunks*9*Cin*Cout values, with n_chunks*chunk >= B*Ho*Wo and
// chunk a multiple of 16; dk (9,Cin,Cout) f32. All contiguous on the device
// of `stream`. Returns the first nonzero cudaGetLastError() of the two
// launches.
extern "C" int sphere_conv_dk_f32(const void* x, const void* g, const void* rows,
                                  const void* shifts, const void* w0, const void* jdev,
                                  void* partial, void* dk, int B, int H, int W, int Cin,
                                  int Cout, int stride, int chunk, int n_chunks, void* stream) {
  return launch<float>(x, g, rows, shifts, w0, jdev, partial, dk, B, H, W, Cin, Cout, stride,
                       chunk, n_chunks, stream);
}

extern "C" int sphere_conv_dk_bf16(const void* x, const void* g, const void* rows,
                                   const void* shifts, const void* w0, const void* jdev,
                                   void* partial, void* dk, int B, int H, int W, int Cin,
                                   int Cout, int stride, int chunk, int n_chunks,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, g, rows, shifts, w0, jdev, partial, dk, B, H, W, Cin, Cout,
                               stride, chunk, n_chunks, stream);
}
