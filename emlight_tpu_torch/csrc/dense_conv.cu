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
// What bounds them on an H100: operations. At the model's widths (Cin 48,
// Cout 12) each does 2*9*Cin*Cout = 10368 flops per pixel on 240 bytes
// (f32) of input and output, 43 flops a byte, above the f32 CUDA cores'
// ridge of 20. The TPU kernel put the 9 taps on one MXU matmul against a
// 128-lane padded operand; none of that carries over (no lane padding, no
// T matrix, no halo DMA). Here, simple and exact first:
//
// conv_kernel<T, DX> (B7 with DX = false, B7' with DX = true): one block of
//   64 threads per tile of 8 x 32 output pixels and 12 output channels.
//   For each slab of 16 input channels it stages the (8+2) x (32+2) window
//   in shared memory, the affine applied on load (B7) and 0 written outside
//   the image, beside the slab's 9 x 16 x 12 kernel values (B7' reads K
//   tap-reversed and transposed on the way in). Each thread accumulates 4
//   pixels (columns tx, tx+8, tx+16, tx+24 of one row: neighbouring threads
//   read neighbouring words) x 12 channels in registers. Cin 48 and Cout 12
//   run unpadded; ragged widths and edges are masked. In B7' each block also
//   writes its own partial dA and dB per channel, summed over its pixels in
//   a fixed order; reduce_kernel then sums the blocks' partials in a fixed
//   order. No atomics: dA and dB are the same from run to run.
// dk_partial_kernel<T> (B8): one block of 144 threads (9 taps x 16 input
//   channels, 12 output channels each) per (pixel chunk, 16-channel input
//   tile, 12-channel output tile). For each 8 x 32 pixel tile of its chunk
//   it stages the y window (affine on load, zero border) and the g tile,
//   and each thread adds y * g over the tile's pixels into 12 registers. It
//   writes one f32 partial per chunk; dk_reduce_kernel sums the chunks in
//   chunk order. No atomics.
// bf16 inputs are read as bf16, y is rounded to bf16 as the forward's
// operand is, and everything is computed and written in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;                 // output rows per tile
constexpr int TW = 32;                // output columns per tile
constexpr int PX = 4;                 // pixels per thread (conv)
constexpr int NTX = TW / PX;          // threads along a tile row
constexpr int NTHREADS = NTX * TH;    // 64 (conv)
constexpr int CK = 16;                // input channels per staged slab
constexpr int CO = 12;                // output channels per block
constexpr int WR = TH + 2;            // window rows
constexpr int WC = TW + 2;            // window columns
constexpr int WP = 40;                // window row pitch: the 4 rows of a warp on disjoint banks
constexpr int CP = WR * WP + 1;       // window channel pitch (odd: staging stores spread over banks)
constexpr int DK_THREADS = 9 * CK;    // 144 (dK)
constexpr int RED_THREADS = 256;

static_assert(CO % 4 == 0, "kernel rows are read as float4");

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

// B7 (DX = false): in = x (B,H,W,Cin), kmat (9,Cin,Cout), out (B,H,W,Cout).
// B7' (DX = true): in = g (B,H,W,Cin) with Cin the forward's Cout, kmat the
// forward's (9,Cout,Cin), out = dx (B,H,W,Cout) with Cout the forward's Cin;
// partial (2, n_pix_blocks, Cout) receives each block's dB (row 0) and dA
// (row 1) over its pixels.
template <typename T, bool DX>
__global__ void __launch_bounds__(NTHREADS)
conv_kernel(const T* __restrict__ in, const T* __restrict__ kmat, const float* __restrict__ a,
            const float* __restrict__ bvec, const T* __restrict__ xorig, float* __restrict__ out,
            float* __restrict__ partial, int H, int W, int Cin, int Cout) {
  __shared__ float y_s[CK * CP];
  __shared__ __align__(16) float k_s[9 * CK * CO];

  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const int n_og = (Cout + CO - 1) / CO;
  const int b = blockIdx.z / n_og;
  const int og = blockIdx.z - b * n_og;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  const T* inb = in + (size_t)b * H * W * Cin;

  float acc[PX][CO];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[i][o] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += CK) {
    const int kc = min(CK, Cin - k0);
    __syncthreads();
    // the window, channel fastest so neighbouring threads read neighbouring values
    for (int e = tid; e < WR * WC * CK; e += NTHREADS) {
      const int c = e % CK;
      const int pw = e / CK;
      const int wr = pw / WC;
      const int wc = pw - wr * WC;
      const int gr = r0 - 1 + wr;
      const int gc = c0 - 1 + wc;
      float v = 0.f;
      if (c < kc && gr >= 0 && gr < H && gc >= 0 && gc < W) {
        v = Num<T>::load(inb[((size_t)gr * W + gc) * Cin + k0 + c]);
        if (!DX) v = Num<T>::round(fmaf(v, a[k0 + c], bvec[k0 + c]));
      }
      y_s[c * CP + wr * WP + wc] = v;
    }
    for (int e = tid; e < 9 * CK * CO; e += NTHREADS) {
      const int o = e % CO;
      const int c = (e / CO) % CK;
      const int t = e / (CO * CK);
      const int oo = og * CO + o;
      float v = 0.f;
      if (c < kc && oo < Cout) {
        // B7': K tap-reversed and transposed, K'[t][c][o] = K[8 - t][o][c]
        const size_t idx = DX ? ((size_t)(8 - t) * Cout + oo) * Cin + k0 + c
                              : ((size_t)t * Cin + k0 + c) * Cout + oo;
        v = Num<T>::load(kmat[idx]);
      }
      k_s[e] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kc; ++c) {
      const float* ys = y_s + c * CP + ty * WP + tx;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* kp = reinterpret_cast<const float4*>(k_s + ((ky * 3 + kx) * CK + c) * CO);
          float kv[CO];
#pragma unroll
          for (int q = 0; q < CO / 4; ++q) {
            const float4 k4 = kp[q];
            kv[4 * q] = k4.x;
            kv[4 * q + 1] = k4.y;
            kv[4 * q + 2] = k4.z;
            kv[4 * q + 3] = k4.w;
          }
#pragma unroll
          for (int i = 0; i < PX; ++i) {
            const float yv = ys[ky * WP + kx + NTX * i];
#pragma unroll
            for (int o = 0; o < CO; ++o) acc[i][o] = fmaf(yv, kv[o], acc[i][o]);
          }
        }
    }
  }

  const int r = r0 + ty;
  float db[CO], da[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) db[o] = da[o] = 0.f;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int col = c0 + tx + NTX * i;
    if (r >= H || col >= W) continue;
    const size_t pix = ((size_t)b * H + r) * W + col;
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      const int oo = og * CO + o;
      if (oo >= Cout) continue;
      if (DX) {
        db[o] += acc[i][o];
        da[o] = fmaf(acc[i][o], Num<T>::load(xorig[pix * Cout + oo]), da[o]);
        out[pix * Cout + oo] = acc[i][o] * a[oo];  // a multiplies AFTER the sum
      } else {
        out[pix * Cout + oo] = acc[i][o];
      }
    }
  }
  if (DX) {
    // the block's dB and dA: per thread over its pixels above, then over the
    // threads in thread order
    __syncthreads();
    float* red = y_s;  // NTHREADS x 2*CO floats, fits in the window's space
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      red[tid * 2 * CO + o] = db[o];
      red[tid * 2 * CO + CO + o] = da[o];
    }
    __syncthreads();
    if (tid < 2 * CO) {
      const int kind = tid / CO;
      const int o = tid - kind * CO;
      const int oo = og * CO + o;
      float s = 0.f;
      for (int k = 0; k < NTHREADS; ++k) s += red[k * 2 * CO + tid];
      const int n_pix_blocks = gridDim.x * gridDim.y * (gridDim.z / n_og);
      const int pb = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      if (oo < Cout) partial[((size_t)kind * n_pix_blocks + pb) * Cout + oo] = s;
    }
  }
}

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

// partial[chunk][t][c][o] = sum over the chunk's tiles of y[p + off_t, c] g[p, o]
template <typename T>
__global__ void __launch_bounds__(DK_THREADS)
dk_partial_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ a,
                  const float* __restrict__ bvec, float* __restrict__ partial, int B, int H,
                  int W, int Cin, int Cout, int tiles_per_chunk) {
  __shared__ float y_s[WR * WC * CK];  // pixel-major, the 16 channels of a pixel together
  __shared__ __align__(16) float g_s[TH * TW * CO];

  const int tid = threadIdx.x;
  const int t = tid / CK;
  const int c = tid - t * CK;
  const int ky = t / 3;
  const int kx = t - ky * 3;
  const int k0 = blockIdx.y * CK;
  const int o0 = blockIdx.z * CO;
  const int kc = min(CK, Cin - k0);
  const int n_tx = (W + TW - 1) / TW;
  const int n_ty = (H + TH - 1) / TH;
  const int n_tiles = B * n_ty * n_tx;
  const int first = blockIdx.x * tiles_per_chunk;
  const int last = min(n_tiles, first + tiles_per_chunk);

  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.f;

  for (int tile = first; tile < last; ++tile) {
    const int b = tile / (n_ty * n_tx);
    const int rem = tile - b * n_ty * n_tx;
    const int r0 = (rem / n_tx) * TH;
    const int c0 = (rem % n_tx) * TW;
    __syncthreads();
    for (int e = tid; e < WR * WC * CK; e += DK_THREADS) {
      const int cc = e % CK;
      const int pw = e / CK;
      const int wr = pw / WC;
      const int wc = pw - wr * WC;
      const int gr = r0 - 1 + wr;
      const int gc = c0 - 1 + wc;
      float v = 0.f;
      if (cc < kc && gr >= 0 && gr < H && gc >= 0 && gc < W) {
        v = Num<T>::load(x[(((size_t)b * H + gr) * W + gc) * Cin + k0 + cc]);
        v = Num<T>::round(fmaf(v, a[k0 + cc], bvec[k0 + cc]));
      }
      y_s[e] = v;
    }
    for (int e = tid; e < TH * TW * CO; e += DK_THREADS) {
      const int o = e % CO;
      const int p = e / CO;
      const int gr = r0 + p / TW;
      const int gc = c0 + p % TW;
      float v = 0.f;
      if (o0 + o < Cout && gr < H && gc < W)
        v = Num<T>::load(g[(((size_t)b * H + gr) * W + gc) * Cout + o0 + o]);
      g_s[e] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < TH * TW; ++p) {
      const int pr = p / TW;
      const int pc = p - pr * TW;
      const float yv = y_s[((pr + ky) * WC + pc + kx) * CK + c];
      const float4* gp = reinterpret_cast<const float4*>(g_s + p * CO);
#pragma unroll
      for (int q = 0; q < CO / 4; ++q) {
        const float4 g4 = gp[q];
        acc[4 * q] = fmaf(yv, g4.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(yv, g4.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(yv, g4.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(yv, g4.w, acc[4 * q + 3]);
      }
    }
  }
  if (c < kc) {
    float* dst = partial + (((size_t)blockIdx.x * 9 + t) * Cin + k0 + c) * Cout + o0;
#pragma unroll
    for (int o = 0; o < CO; ++o)
      if (o0 + o < Cout) dst[o] = acc[o];
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

inline dim3 conv_grid(int B, int H, int W, int Cout) {
  return dim3((W + TW - 1) / TW, (H + TH - 1) / TH, B * ((Cout + CO - 1) / CO));
}

template <typename T>
int fwd(const void* x, const void* a, const void* b, const void* k, void* out, int B, int H,
        int W, int Cin, int Cout, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
  conv_kernel<T, false><<<conv_grid(B, H, W, Cout), NTHREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)k, (const float*)a, (const float*)b, nullptr, (float*)out, nullptr,
      H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

template <typename T>
int dx(const void* g, const void* x, const void* a, const void* k, void* dxp, void* partial,
       void* da, void* db, int B, int H, int W, int Cin, int Cout, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // the transposed conv: reads g's Cout channels, writes Cin
  const dim3 grid = conv_grid(B, H, W, Cin);
  conv_kernel<T, true><<<grid, NTHREADS, 0, st>>>((const T*)g, (const T*)k, (const float*)a,
                                                  nullptr, (const T*)x, (float*)dxp,
                                                  (float*)partial, H, W, Cout, Cin);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  reduce_kernel<<<dim3(Cin, 2), RED_THREADS, 0, st>>>((const float*)partial, (float*)db,
                                                      (float*)da, B * grid.y * grid.x, Cin);
  return (int)cudaGetLastError();
}

template <typename T>
int dk(const void* x, const void* g, const void* a, const void* b, void* partial, void* dkp,
       int B, int H, int W, int Cin, int Cout, int tiles_per_chunk, int n_chunks, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || tiles_per_chunk < 1 || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(n_chunks, (Cin + CK - 1) / CK, (Cout + CO - 1) / CO);
  dk_partial_kernel<T><<<grid, DK_THREADS, 0, st>>>((const T*)x, (const T*)g, (const float*)a,
                                                    (const float*)b, (float*)partial, B, H, W,
                                                    Cin, Cout, tiles_per_chunk);
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
// B7: x (B,H,W,Cin), k (3,3,Cin,Cout) -> out (B,H,W,Cout).
extern "C" int dense_conv_fwd_f32(const void* x, const void* a, const void* b, const void* k,
                                  void* out, int B, int H, int W, int Cin, int Cout,
                                  void* stream) {
  return fwd<float>(x, a, b, k, out, B, H, W, Cin, Cout, stream);
}

extern "C" int dense_conv_fwd_bf16(const void* x, const void* a, const void* b, const void* k,
                                   void* out, int B, int H, int W, int Cin, int Cout,
                                   void* stream) {
  return fwd<__nv_bfloat16>(x, a, b, k, out, B, H, W, Cin, Cout, stream);
}

// B7': g (B,H,W,Cout), x (B,H,W,Cin), k (3,3,Cin,Cout) -> dx (B,H,W,Cin),
// da, db (Cin); partial is an f32 scratch of 2 * B * ceil(H/8) * ceil(W/32) * Cin.
extern "C" int dense_conv_dx_f32(const void* g, const void* x, const void* a, const void* k,
                                 void* dx_out, void* partial, void* da, void* db, int B, int H,
                                 int W, int Cin, int Cout, void* stream) {
  return dx<float>(g, x, a, k, dx_out, partial, da, db, B, H, W, Cin, Cout, stream);
}

extern "C" int dense_conv_dx_bf16(const void* g, const void* x, const void* a, const void* k,
                                  void* dx_out, void* partial, void* da, void* db, int B, int H,
                                  int W, int Cin, int Cout, void* stream) {
  return dx<__nv_bfloat16>(g, x, a, k, dx_out, partial, da, db, B, H, W, Cin, Cout, stream);
}

// B8: x (B,H,W,Cin), g (B,H,W,Cout) -> dk (3,3,Cin,Cout); partial is an f32
// scratch of n_chunks * 9 * Cin * Cout, each chunk tiles_per_chunk 8x32 tiles.
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
