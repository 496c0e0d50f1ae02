// Sphere conv forward, stride 2 — hand-written CUDA C++ for sm_90a (H100).
//
// Replaces emlight_tpu/nn/sphere_conv_pallas.py::_kernel at stride 2 (the
// Pallas TPU kernel B2, launched by sphere_conv_pallas). For each output
// pixel (b, i, j) of the (Ho, Wo) = (H/2, W/2) map and output channel o:
//
//   out[b,i,j,o] = bias[o] + sum_{t<9} sum_c S[b,i,j,t,c] * K[t,c,o]
//   S[b,i,j,t,c] = sum_{k<4} w(i,t,k,j) * x[b, rows[i,t,k], (2j + shift[i,t,k]) mod W, c]
//   w(i,t,k,j)   = 0 if j == jdev[i,t,k] else w0[i,t,k]
//
// The (Ho, 9, 4) tables come from structured_tables(h, w, 2) and
// scalar_weight_tables(h, w, 2) (nn/sphere_conv_kernel.py), which assert at
// build time that this decomposition is exact.
//
// What bounds it on an H100: operations for the discriminator's wide convs
// (2*9*Cin*Cout flops per output pixel, f32 on the CUDA cores); the cin=6
// front conv, which reads 4 input pixels per output pixel for 64 outputs,
// sits near the f32 ridge. The design is the stride-1 kernel's
// (csrc/sphere_conv_s1.cu): a block computes BM=64 flat output pixels by
// BN=64 output channels, stages the sampled (BM, BK=16) operand in shared
// memory tap by tap (the 4 weighted reads, circular shift and dead column
// applied on the way in) beside the (BK, BN) slab of K_t, and accumulates a
// 4x4 register micro-tile per thread. Only the column map differs: output
// col j reads input col 2j + shift, wrapped once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output pixels per block (flat i*Wo + j)
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels per staged slab
constexpr int TM = 4;    // pixels per thread
constexpr int TN = 4;    // output channels per thread
constexpr int NTHREADS = (BM / TM) * (BN / TN);  // 256
constexpr int STAGE_PER_THREAD = BM * BK / NTHREADS;  // 4
constexpr int TAB = 36;  // 9 taps x 4 neighbours

// output rows one BM-pixel tile can span (sizes the dynamic table memory)
inline int rows_spanned(int Ho, int Wo) {
  const int span = (BM - 1) / Wo + 2;
  return span < Ho ? span : Ho;
}

static_assert(NTHREADS % BK == 0, "staging maps one input channel per thread");

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

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
sphere_conv_s2_kernel(const T* __restrict__ x, const T* __restrict__ kmat,
                      const float* __restrict__ bias, const int* __restrict__ rows,
                      const int* __restrict__ shifts, const float* __restrict__ w0,
                      const int* __restrict__ jdev, float* __restrict__ out,
                      int H, int W, int Cin, int Cout, int span) {
  __shared__ float s_tile[BK][BM + 2];
  __shared__ float k_tile[BK][BN];
  extern __shared__ int tab_smem[];
  int* t_row = tab_smem;
  int* t_shift = t_row + span * TAB;
  int* t_jdev = t_shift + span * TAB;
  float* t_w0 = reinterpret_cast<float*>(t_jdev + span * TAB);

  const int Ho = H / 2;
  const int Wo = W / 2;
  const int P = Ho * Wo;
  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int i0 = p0 / Wo;
  const int i_last = min(Ho - 1, (p0 + BM - 1) / Wo);
  const int n_tab = (i_last - i0 + 1) * TAB;

  for (int e = tid; e < n_tab; e += NTHREADS) {
    const int g = i0 * TAB + e;
    t_row[e] = rows[g];
    t_shift[e] = shifts[g];
    t_jdev[e] = jdev[g];
    t_w0[e] = w0[g];
  }

  const int kk_s = tid % BK;
  int s_tab[STAGE_PER_THREAD];
  int s_j[STAGE_PER_THREAD];
#pragma unroll
  for (int r = 0; r < STAGE_PER_THREAD; ++r) {
    const int p = p0 + tid / BK + r * (NTHREADS / BK);
    const int i = p / Wo;
    s_j[r] = p - i * Wo;
    s_tab[r] = p < P ? (i - i0) * TAB : -1;
  }

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  const T* xb = x + (size_t)b * H * W * Cin;
  __syncthreads();

  for (int t = 0; t < 9; ++t) {
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int c = c0 + kk_s;
#pragma unroll
      for (int r = 0; r < STAGE_PER_THREAD; ++r) {
        float v = 0.f;
        if (s_tab[r] >= 0 && c < Cin) {
          const int j = s_j[r];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = s_tab[r] + t * 4 + q;
            const float wq = (j == t_jdev[e]) ? 0.f : t_w0[e];
            int col = 2 * j + t_shift[e];
            if (col >= W) col -= W;
            v += wq * Num<T>::load(xb[((size_t)t_row[e] * W + col) * Cin + c]);
          }
          v = Num<T>::round(v);
        }
        s_tile[kk_s][tid / BK + r * (NTHREADS / BK)] = v;
      }
      for (int e = tid; e < BK * BN; e += NTHREADS) {
        const int nn = e % BN;
        const int kk = e / BN;
        const int ck = c0 + kk;
        const int o = n0 + nn;
        k_tile[kk][nn] = (ck < Cin && o < Cout)
                             ? Num<T>::load(kmat[((size_t)t * Cin + ck) * Cout + o])
                             : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], bv[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) a[m] = s_tile[kk][ty + m * (BM / TM)];
#pragma unroll
        for (int n = 0; n < TN; ++n) bv[n] = k_tile[kk][tx + n * (BN / TN)];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], bv[n], acc[m][n]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int p = p0 + ty + m * (BM / TM);
    if (p >= P) continue;
    float* orow = out + ((size_t)b * P + p) * Cout;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int o = n0 + tx + n * (BN / TN);
      if (o < Cout) orow[o] = acc[m][n] + bias[o];
    }
  }
}

template <typename T>
int launch(const void* x, const void* kmat, const void* bias, const void* rows,
           const void* shifts, const void* w0, const void* jdev, void* out, int B,
           int H, int W, int Cin, int Cout, void* stream) {
  const int Ho = H / 2, Wo = W / 2;
  const int span = rows_spanned(Ho, Wo);
  const size_t smem = (size_t)4 * span * TAB * sizeof(int);
  const dim3 grid((Ho * Wo + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  sphere_conv_s2_kernel<T><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)kmat, (const float*)bias, (const int*)rows,
      (const int*)shifts, (const float*)w0, (const int*)jdev, (float*)out, H, W,
      Cin, Cout, span);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. x (B,H,W,Cin) and kmat (9,Cin,Cout) in the
// named dtype (H and W even), bias (Cout,) f32, tables (H/2,9,4) int32/f32,
// out (B,H/2,W/2,Cout) f32; all contiguous on the device of `stream`.
// Returns cudaGetLastError().
extern "C" int sphere_conv_s2_f32(const void* x, const void* kmat, const void* bias,
                                  const void* rows, const void* shifts,
                                  const void* w0, const void* jdev, void* out,
                                  int B, int H, int W, int Cin, int Cout,
                                  void* stream) {
  return launch<float>(x, kmat, bias, rows, shifts, w0, jdev, out, B, H, W, Cin,
                       Cout, stream);
}

extern "C" int sphere_conv_s2_bf16(const void* x, const void* kmat, const void* bias,
                                   const void* rows, const void* shifts,
                                   const void* w0, const void* jdev, void* out,
                                   int B, int H, int W, int Cin, int Cout,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, kmat, bias, rows, shifts, w0, jdev, out, B, H,
                               W, Cin, Cout, stream);
}
