// Sphere conv input gradient (dx) at stride 1, per-triple form — hand-written
// CUDA C++ for sm_90a (H100).
//
// Replaces emlight_tpu/nn/sphere_conv_vjp.py::_dx_kernel_s1 (the Pallas TPU
// kernel B6, launched by _dx_pallas for the maps of fewer than 2048 pixels).
// It computes the same dx as csrc/sphere_conv_dx.cu's stride-1 path (B3):
//
//   dx[r][col] = sum over the slots m of input row r (the port's
//                inverse_tables: out_row i, tap t, shift s, weight w0, dead
//                column jdev), in slot order, of
//                w0 * (g[i] @ K_t^T)[(col - s) mod W],  skipped where
//                (col - s) mod W == jdev
//
// but without B3's U scratch in device memory: the row u = g[i] @ K_t^T is
// recomputed in the block for the input row that reads it, as the TPU kernel
// did. Slots come in runs that share (out_row, tap), the up to 4 bilinear
// neighbours of one tap; the block computes u once per run, keeps it in
// shared memory and adds it once per slot of the run. Each (out_row, tap)
// row of U is thus computed by each input row that reads it (about twice
// B3's operations), never written to device memory.
//
// What bounds it on an H100: operations (2 * W * Cin * Cout flops per run
// and image on a g row of W * Cout and a K_t of Cin * Cout values) and, at
// the small W of these maps, the shared-memory staging of K_t, which each
// run reads once per block. Design, simple first: one block per (input row,
// group of images, cin tile, cout split). The group holds as many images as
// make 64 rows of u (W columns each), so one staged K_t value feeds 64 rows;
// each thread owns 4 consecutive rows x 4 consecutive channels. For each run
// it walks its cout range in slabs of 32: stages the slab of g's rows i and
// of K_t in shared memory (8 loads in flight per thread) and accumulates its
// 4 x 4 piece of u (two 16-byte shared loads per 16 FMAs); then u goes to
// shared memory and each slot of the run adds w0 * u at the shifted columns,
// except at the dead column, into registers. Padded slots (w0 == 0) are
// skipped, never multiplied, so an inf in g cannot turn into a NaN. The
// small maps give few (row, group, cin tile) blocks, so the wrapper splits
// cout until the grid has about 2 blocks per SM: each split writes a partial
// dx (dx is linear in u) and reduce_kernel sums the splits in order. No
// atomics: each dx value is summed in slot order, then split order, the
// same from run to run.
// bf16 inputs are read as bf16 and computed in f32; dx is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 4;            // consecutive rows of u per thread
constexpr int TCH = 4;           // consecutive channels per thread
constexpr int OT = 32;           // cout slab
constexpr int NT = 256;          // most threads per block
constexpr int MAX_R = 128;       // most rows (one image of the widest row)
constexpr int MAX_CT = 64;       // widest cin tile
constexpr int MAX_W = 128;
constexpr int MAX_FANIN = 64;
constexpr int INFLIGHT = 8;      // staging loads per thread issued together

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
};

// dst[e] = src(e) for e < n, INFLIGHT independent loads per thread at a time
template <typename F, typename G>
__device__ __forceinline__ void stage(int n, int tid, int nthreads, F src, G dst) {
  for (int base = tid; base < n; base += INFLIGHT * nthreads) {
    float v[INFLIGHT];
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k) {
      const int e = base + k * nthreads;
      v[k] = e < n ? src(e) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k) {
      const int e = base + k * nthreads;
      if (e < n) dst(e, v[k]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
dx_triple_kernel(const T* __restrict__ g, const T* __restrict__ kmat, const int* __restrict__ orow,
                 const int* __restrict__ tap, const int* __restrict__ shift,
                 const float* __restrict__ w0, const int* __restrict__ jdev,
                 float* __restrict__ out, int B, int H, int W, int Cin, int Cout, int fanin,
                 int bb, int ct, int n_split) {
  __shared__ int s_row[MAX_FANIN];
  __shared__ int s_tap[MAX_FANIN];
  __shared__ int s_shift[MAX_FANIN];
  __shared__ int s_jdev[MAX_FANIN];
  __shared__ float s_w0[MAX_FANIN];
  __shared__ __align__(16) float k_s[OT * (MAX_CT + 4)];  // K_t[c][o] as k_s[o][c]
  __shared__ __align__(16) float g_s[OT * (MAX_R + 4)];   // g[b][i][j][o] as g_s[o][row]
  __shared__ __align__(16) float u_s[NT * TR * TCH];      // the run's u, [row][c]

  const int R = bb * W;                // rows: image-major, then column
  const int nrg = (R + TR - 1) / TR;
  const int rp = nrg * TR + 4;         // g_s pitch (16-byte aligned)
  const int kp = ct + 4;               // k_s pitch
  const int nchg = ct / TCH;
  const int n_ct = (Cin + ct - 1) / ct;
  const int sp = blockIdx.z / n_ct;    // cout split
  const int r = blockIdx.x;
  const int b0 = blockIdx.y * bb;
  const int c0 = (blockIdx.z - sp * n_ct) * ct;
  const int slabs = (Cout + OT - 1) / OT;
  const int per = (slabs + n_split - 1) / n_split;
  const int o_begin = sp * per * OT;
  const int o_end = min(Cout, o_begin + per * OT);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int rg = tid / nchg;
  const int chg = tid - rg * nchg;
  const bool active = rg < nrg;

  for (int m = tid; m < fanin; m += nthreads) {
    const int idx = r * fanin + m;
    s_row[m] = orow[idx];
    s_tap[m] = tap[idx];
    s_shift[m] = shift[idx];
    s_jdev[m] = jdev[idx];
    s_w0[m] = w0[idx];
  }
  __syncthreads();

  float acc[TR][TCH];
#pragma unroll
  for (int q = 0; q < TR; ++q)
#pragma unroll
    for (int l = 0; l < TCH; ++l) acc[q][l] = 0.f;

  int cur_i = -1, cur_t = -1;
  for (int m = 0; m < fanin; ++m) {
    const float wm = s_w0[m];
    if (wm == 0.f) continue;  // padded slot (uniform across the block)
    const int i = s_row[m];
    const int t = s_tap[m];
    if (i != cur_i || t != cur_t) {  // a new run: u = g[:, i] @ K_t^T (uniform)
      cur_i = i;
      cur_t = t;
      float u[TR][TCH];
#pragma unroll
      for (int q = 0; q < TR; ++q)
#pragma unroll
        for (int l = 0; l < TCH; ++l) u[q][l] = 0.f;
      const T* kt = kmat + (size_t)t * Cin * Cout;
      for (int o0 = o_begin; o0 < o_end; o0 += OT) {
        __syncthreads();  // the slabs are free
        stage(R * OT, tid, nthreads,
              [&](int e) {
                const int o = o0 + e % OT;
                const int row = e / OT;
                const int b = b0 + row / W;
                return (b < B && o < o_end)
                           ? Num<T>::load(g[(((size_t)b * H + i) * W + row % W) * Cout + o])
                           : 0.f;
              },
              [&](int e, float v) { g_s[(e % OT) * rp + e / OT] = v; });
        stage(ct * OT, tid, nthreads,
              [&](int e) {
                const int o = o0 + e % OT;
                const int c = c0 + e / OT;
                return (c < Cin && o < o_end) ? Num<T>::load(kt[(size_t)c * Cout + o]) : 0.f;
              },
              [&](int e, float v) { k_s[(e % OT) * kp + e / OT] = v; });
        __syncthreads();
        if (active) {
#pragma unroll 8
          for (int o = 0; o < OT; ++o) {
            const float4 g4 = *reinterpret_cast<const float4*>(g_s + o * rp + rg * TR);
            const float4 k4 = *reinterpret_cast<const float4*>(k_s + o * kp + chg * TCH);
            u[0][0] = fmaf(g4.x, k4.x, u[0][0]); u[0][1] = fmaf(g4.x, k4.y, u[0][1]);
            u[0][2] = fmaf(g4.x, k4.z, u[0][2]); u[0][3] = fmaf(g4.x, k4.w, u[0][3]);
            u[1][0] = fmaf(g4.y, k4.x, u[1][0]); u[1][1] = fmaf(g4.y, k4.y, u[1][1]);
            u[1][2] = fmaf(g4.y, k4.z, u[1][2]); u[1][3] = fmaf(g4.y, k4.w, u[1][3]);
            u[2][0] = fmaf(g4.z, k4.x, u[2][0]); u[2][1] = fmaf(g4.z, k4.y, u[2][1]);
            u[2][2] = fmaf(g4.z, k4.z, u[2][2]); u[2][3] = fmaf(g4.z, k4.w, u[2][3]);
            u[3][0] = fmaf(g4.w, k4.x, u[3][0]); u[3][1] = fmaf(g4.w, k4.y, u[3][1]);
            u[3][2] = fmaf(g4.w, k4.z, u[3][2]); u[3][3] = fmaf(g4.w, k4.w, u[3][3]);
          }
        }
      }
      __syncthreads();  // the previous run's u_s is read
      if (active) {
#pragma unroll
        for (int q = 0; q < TR; ++q)
          *reinterpret_cast<float4*>(u_s + (rg * TR + q) * ct + chg * TCH) =
              make_float4(u[q][0], u[q][1], u[q][2], u[q][3]);
      }
      __syncthreads();
    }
    if (active) {
      const int s = s_shift[m];
      const int jd = s_jdev[m];
#pragma unroll
      for (int q = 0; q < TR; ++q) {
        const int row = rg * TR + q;
        const int img = row / W;
        int j = (row - img * W - s) % W;
        if (j < 0) j += W;
        if (row >= R || j == jd) continue;  // jd: grid_sample's zero pad, adds nothing
        const float4 u4 = *reinterpret_cast<const float4*>(u_s + (img * W + j) * ct + chg * TCH);
        acc[q][0] = fmaf(wm, u4.x, acc[q][0]);
        acc[q][1] = fmaf(wm, u4.y, acc[q][1]);
        acc[q][2] = fmaf(wm, u4.z, acc[q][2]);
        acc[q][3] = fmaf(wm, u4.w, acc[q][3]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int q = 0; q < TR; ++q) {
    const int row = rg * TR + q;
    const int b = b0 + row / W;
    if (row >= R || b >= B) continue;
    // the split's partial dx (dx itself when cout is not split)
    float* dxp = out + ((((size_t)sp * B + b) * H + r) * W + row % W) * Cin;
#pragma unroll
    for (int l = 0; l < TCH; ++l) {
      const int c = c0 + chg * TCH + l;
      if (c < Cin) dxp[c] = acc[q][l];
    }
  }
}

// dx[e] = sum over the splits of part[split][e], in split order
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ dx, size_t n,
                              int n_split) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < n_split; ++k) s += part[k * n + e];
  dx[e] = s;
}

template <typename T>
int launch(const void* g, const void* kmat, const void* orow, const void* tap, const void* shift,
           const void* w0, const void* jdev, void* partial, void* dx, int B, int H, int W,
           int Cin, int Cout, int fanin, int bb, int ct, int n_split, void* stream) {
  const int nrg = (bb * W + TR - 1) / TR;
  const int threads = (nrg * (ct / TCH) + 31) / 32 * 32;
  if (B < 1 || H < 1 || W < 1 || W > MAX_W || Cin < 1 || Cout < 1 || fanin < 1 ||
      fanin > MAX_FANIN || bb < 1 || bb * W > MAX_R || ct < TCH || ct % TCH || ct > MAX_CT ||
      threads > NT || n_split < 1 || (n_split > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(H, (B + bb - 1) / bb, ((Cin + ct - 1) / ct) * n_split);
  dx_triple_kernel<T><<<grid, threads, 0, st>>>(
      (const T*)g, (const T*)kmat, (const int*)orow, (const int*)tap, (const int*)shift,
      (const float*)w0, (const int*)jdev, (float*)(n_split > 1 ? partial : dx), B, H, W, Cin,
      Cout, fanin, bb, ct, n_split);
  int rc = (int)cudaGetLastError();
  if (rc || n_split == 1) return rc;
  const size_t n = (size_t)B * H * W * Cin;
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const float*)partial, (float*)dx, n,
                                                             n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. g (B,H,W,Cout) and kmat (9,Cin,Cout) in the
// named dtype; inverse tables (H,fanin) int32/f32; dx (B,H,W,Cin) f32, every
// value written. W at most 128. The tiling comes from the wrapper
// (nn/sphere_conv_kernel.py::triple_tiles): bb images and ct channels per
// block, cout in n_split parts; with n_split > 1, partial is an f32 scratch of
// n_split * B*H*W*Cin values. All contiguous on the device of `stream`.
// Returns the first nonzero cudaGetLastError() of the launches.
extern "C" int sphere_conv_dx_triple_f32(const void* g, const void* kmat, const void* orow,
                                         const void* tap, const void* shift, const void* w0,
                                         const void* jdev, void* partial, void* dx, int B, int H,
                                         int W, int Cin, int Cout, int fanin, int bb, int ct,
                                         int n_split, void* stream) {
  return launch<float>(g, kmat, orow, tap, shift, w0, jdev, partial, dx, B, H, W, Cin, Cout,
                       fanin, bb, ct, n_split, stream);
}

extern "C" int sphere_conv_dx_triple_bf16(const void* g, const void* kmat, const void* orow,
                                          const void* tap, const void* shift, const void* w0,
                                          const void* jdev, void* partial, void* dx, int B, int H,
                                          int W, int Cin, int Cout, int fanin, int bb, int ct,
                                          int n_split, void* stream) {
  return launch<__nv_bfloat16>(g, kmat, orow, tap, shift, w0, jdev, partial, dx, B, H, W, Cin,
                               Cout, fanin, bb, ct, n_split, stream);
}
