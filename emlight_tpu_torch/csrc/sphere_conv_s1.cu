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
// which assert at build time that this decomposition is exact.
//
// What bounds it on an H100: operations. At the generator's widths a conv
// does 2*9*Cin*Cout flops per output pixel against (Cin + Cout) * 4 bytes of
// input and output, i.e. 100-1000 flops per byte, above the card's f32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 flops per byte); only the cin=3 and
// cout=3 convs sit below it. The gather itself is cheap: the 4-neighbour
// sources of one output row lie in the input rows [i-2, i+1] (a halo the L2
// and L1 keep hot), so each input byte leaves device memory about once.
//
// What this design does about it: the matmul runs in this kernel, in f32 on
// the CUDA cores, as a register-tiled product. One block computes a tile of
// BM=64 flat output pixels (several output rows when W < 64, so small maps
// waste no lanes) by BN=64 output channels. For each tap and each BK=16
// input-channel slab it stages the sampled (BM, BK) operand in shared memory
// (the 4 weighted reads, circular shift and dead column applied on the way
// in, so S never touches device memory) beside the (BK, BN) slab of K_t, and
// every thread accumulates a 4x4 micro-tile in registers. bf16 inputs are
// read as bf16 and computed in f32 (the staged operand is rounded to bf16,
// as the plain version does). Tensor cores (wgmma), TMA and a pipelined
// ring of stages are the next step and are not used here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output pixels per block (flat i*W + j)
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels per staged slab
constexpr int TM = 4;    // pixels per thread
constexpr int TN = 4;    // output channels per thread
constexpr int NTHREADS = (BM / TM) * (BN / TN);  // 256
constexpr int STAGE_PER_THREAD = BM * BK / NTHREADS;  // 4
constexpr int TAB = 36;  // 9 taps x 4 neighbours

// output rows one BM-pixel tile can span (sizes the dynamic table memory)
inline int rows_spanned(int H, int W) {
  const int span = (BM - 1) / W + 2;
  return span < H ? span : H;
}

static_assert(NTHREADS % BK == 0, "staging maps one input channel per thread");
static_assert(BK * BN % NTHREADS == 0, "K slab divides over the block");

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
sphere_conv_s1_kernel(const T* __restrict__ x, const T* __restrict__ kmat,
                      const float* __restrict__ bias, const int* __restrict__ rows,
                      const int* __restrict__ shifts, const float* __restrict__ w0,
                      const int* __restrict__ jdev, float* __restrict__ out,
                      int H, int W, int Cin, int Cout, int span) {
  // row stride BM+2: the 16 channels x 2 pixels one warp stages land in 32
  // distinct banks
  __shared__ float s_tile[BK][BM + 2];
  __shared__ float k_tile[BK][BN];
  // the tables of the output rows this tile spans (span * TAB entries each)
  extern __shared__ int tab_smem[];
  int* t_row = tab_smem;
  int* t_shift = t_row + span * TAB;
  int* t_jdev = t_shift + span * TAB;
  float* t_w0 = reinterpret_cast<float*>(t_jdev + span * TAB);

  const int P = H * W;
  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int i0 = p0 / W;
  const int i_last = min(H - 1, (p0 + BM - 1) / W);
  const int n_tab = (i_last - i0 + 1) * TAB;

  for (int e = tid; e < n_tab; e += NTHREADS) {
    const int g = i0 * TAB + e;
    t_row[e] = rows[g];
    t_shift[e] = shifts[g];
    t_jdev[e] = jdev[g];
    t_w0[e] = w0[g];
  }

  // staging: this thread fills channel kk of pixels jj_r = tid/BK + r*(NTHREADS/BK)
  const int kk_s = tid % BK;
  int s_tab[STAGE_PER_THREAD];  // table offset of the pixel's row, -1 past the end
  int s_j[STAGE_PER_THREAD];
#pragma unroll
  for (int r = 0; r < STAGE_PER_THREAD; ++r) {
    const int p = p0 + tid / BK + r * (NTHREADS / BK);
    const int i = p / W;
    s_j[r] = p - i * W;
    s_tab[r] = p < P ? (i - i0) * TAB : -1;
  }

  const int tx = tid % (BN / TN);  // output channels tx + 16n
  const int ty = tid / (BN / TN);  // output pixels ty + 16m
  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  const T* xb = x + (size_t)b * P * Cin;
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
            int col = j + t_shift[e];
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
  const int span = rows_spanned(H, W);
  const size_t smem = (size_t)4 * span * TAB * sizeof(int);
  const dim3 grid((H * W + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  sphere_conv_s1_kernel<T><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)kmat, (const float*)bias, (const int*)rows,
      (const int*)shifts, (const float*)w0, (const int*)jdev, (float*)out, H, W,
      Cin, Cout, span);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. x (B,H,W,Cin) and kmat (9,Cin,Cout) in the
// named dtype, bias (Cout,) f32, tables (H,9,4) int32/f32, out (B,H,W,Cout)
// f32; all contiguous on the device of `stream`. Returns cudaGetLastError().
extern "C" int sphere_conv_s1_f32(const void* x, const void* kmat, const void* bias,
                                  const void* rows, const void* shifts,
                                  const void* w0, const void* jdev, void* out,
                                  int B, int H, int W, int Cin, int Cout,
                                  void* stream) {
  return launch<float>(x, kmat, bias, rows, shifts, w0, jdev, out, B, H, W, Cin,
                       Cout, stream);
}

extern "C" int sphere_conv_s1_bf16(const void* x, const void* kmat, const void* bias,
                                   const void* rows, const void* shifts,
                                   const void* w0, const void* jdev, void* out,
                                   int B, int H, int W, int Cin, int Cout,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, kmat, bias, rows, shifts, w0, jdev, out, B, H,
                               W, Cin, Cout, stream);
}
