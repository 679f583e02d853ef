// PCM (pixel correlation module) forward for Hopper, sm_90a.
//
// Replaces the TPU kernel wseg_tpu/kernels/pcm_pallas.py:pcm_fused.
//
// Computes, per sample, with fn_i = mask_i * f_i / (||f_i||_2 + eps):
//     a_ij   = relu(fn_i . fn_j)
//     out_j  = sum_i a_ij * cam_i / (sum_i a_ij + eps)
// without ever storing the hw x hw affinity (604 MB per view in f32 at scale 2
// of a 384x512 image, hw = 12288). It has the shape of attention with j as the
// query: one block owns a tile of BJ columns j over ALL rows i, so the
// normalization is a divide in the epilogue and no second pass is needed.
//
// Bound on the card: operations. Per sample it does 2*hw^2*(Cf + C) flops on
// ~hw*(Cf + 2C)*4 bytes, i.e. thousands of flops per byte, far above the H100's
// ratio. This first version runs in f32 FMA on the CUDA cores (f32 or bf16
// features, converted on load), so its bound is the f32 SIMT peak; tensor
// cores (mma/wgmma), TMA and pipelining are later work.
//
// Design:
//   * pcm_inv_norm_kernel: one warp per pixel computes scale_i =
//     mask_i / (||f_i|| + eps); the main kernel multiplies f by it on load.
//   * pcm_fused_kernel, grid (hw / BJ, N), 256 threads:
//       - the fn_j tile (BJ x Cf) is loaded once into shared memory;
//       - for each row tile i (BI rows), fn_i is staged through shared memory
//         in K chunks of KC channels and S = fn_i fn_j^T is accumulated in
//         registers, a 4x4 block per thread (rows ti + 16r, cols tj + 16q,
//         interleaved so that shared-memory float4 reads do not conflict);
//       - relu(S) goes to shared memory, next to the cam_i tile extended
//         with a column of ones (so the column sums come out of the same
//         product as the propagation);
//       - acc_j += relu(S)^T [cam_i | 1], each thread holding one column j
//         and six channels in registers.
//   * Tails of hw and Cf are bounds-checked and zero-filled; nothing is
//     padded in device memory. C + 1 must fit in CE channels.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BJ = 64;         // columns j per block
constexpr int BI = 64;         // rows i per iteration
constexpr int KC = 32;         // feature channels per staged chunk
constexpr int NT = 256;        // threads per block
constexpr int CE = 24;         // cam channels + ones column, padded (C <= 23)
constexpr int CPT = CE / (NT / BJ);  // channels per thread in the product: 6
constexpr int FIS = KC + 4;    // fi row stride (floats): 9 float4s, odd
constexpr int SSS = BJ + 2;    // relu(S) row stride (floats)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void pcm_inv_norm_kernel(const T* __restrict__ f,
                                    const float* __restrict__ mask,
                                    float* __restrict__ scale,
                                    long long rows, int cf, float eps) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* fr = f + row * cf;
  float ss = 0.f;
  for (int k = lane; k < cf; k += 32) {
    const float v = to_f(fr[k]);
    ss = fmaf(v, v, ss);
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) {
    float s = 1.f / (sqrtf(ss) + eps);
    if (mask != nullptr) s *= mask[row];
    scale[row] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
pcm_fused_kernel(const float* __restrict__ cam, const T* __restrict__ f,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int hw, int c, int cf, int cf_pad, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int fjs = cf_pad + 4;           // fj row stride (floats)
  float* fj_s = smem;                   // BJ x fjs
  float* fi_s = fj_s + BJ * fjs;        // BI x FIS
  float* s_s = fi_s + BI * FIS;         // BI x SSS
  float* cam_s = s_s + BI * SSS;        // BI x CE

  const int n = blockIdx.y;
  const int j0 = blockIdx.x * BJ;
  const int tid = threadIdx.x;
  const T* fb = f + (size_t)n * hw * cf;
  const float* sb = scale + (size_t)n * hw;
  const float* cb = cam + (size_t)n * hw * c;

  for (int e = tid; e < BJ * cf_pad; e += NT) {
    const int r = e / cf_pad, k = e - r * cf_pad;
    const int j = j0 + r;
    float v = 0.f;
    if (j < hw && k < cf) v = to_f(fb[(size_t)j * cf + k]) * sb[j];
    fj_s[r * fjs + k] = v;
  }

  const int ti = tid & 15, tj = tid >> 4;   // S roles: rows ti+16r, cols tj+16q
  const int jj = tid & (BJ - 1);            // product roles: column jj,
  const int g = tid / BJ;                   // channels g*CPT .. g*CPT+CPT-1
  float acc[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) acc[q] = 0.f;

  for (int i0 = 0; i0 < hw; i0 += BI) {
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[r][q] = 0.f;

    for (int k0 = 0; k0 < cf_pad; k0 += KC) {
      __syncthreads();  // fi_s (and, on k0 == 0, s_s / cam_s) free again
      for (int e = tid; e < BI * KC; e += NT) {
        const int r = e / KC, k = e % KC;
        const int i = i0 + r, kk = k0 + k;
        float v = 0.f;
        if (i < hw && kk < cf) v = to_f(fb[(size_t)i * cf + kk]) * sb[i];
        fi_s[r * FIS + k] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KC; k += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = *reinterpret_cast<const float4*>(&fi_s[(ti + 16 * r) * FIS + k]);
          b[r] = *reinterpret_cast<const float4*>(&fj_s[(tj + 16 * r) * fjs + k0 + k]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float t = s[r][q];
            t = fmaf(a[r].x, b[q].x, t);
            t = fmaf(a[r].y, b[q].y, t);
            t = fmaf(a[r].z, b[q].z, t);
            t = fmaf(a[r].w, b[q].w, t);
            s[r][q] = t;
          }
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s_s[(ti + 16 * r) * SSS + tj + 16 * q] = fmaxf(s[r][q], 0.f);
    for (int e = tid; e < BI * CE; e += NT) {
      const int r = e / CE, cc = e - r * CE;
      const int i = i0 + r;
      float v = 0.f;
      if (i < hw) v = cc < c ? cb[(size_t)i * c + cc] : (cc == c ? 1.f : 0.f);
      cam_s[r * CE + cc] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < BI; ++r) {
      const float a = s_s[r * SSS + jj];
      const float* cr = &cam_s[r * CE + g * CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) acc[q] = fmaf(a, cr[q], acc[q]);
    }
  }

  __syncthreads();
  float* colsum_s = s_s;  // reuse: the ones column's sums, one per j
#pragma unroll
  for (int q = 0; q < CPT; ++q)
    if (g * CPT + q == c) colsum_s[jj] = acc[q];
  __syncthreads();
  const int j = j0 + jj;
  if (j < hw) {
    const float denom = colsum_s[jj] + eps;
    float* ob = out + ((size_t)n * hw + j) * c;
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int cc = g * CPT + q;
      if (cc < c) ob[cc] = acc[q] / denom;
    }
  }
}

template <typename T>
int launch(const float* cam, const T* f, const float* mask, float* scale,
           float* out, int n, int hw, int c, int cf, float eps,
           cudaStream_t stream) {
  const long long rows = (long long)n * hw;
  const int rows_per_block = 256 / 32;
  pcm_inv_norm_kernel<T><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                           256, 0, stream>>>(f, mask, scale, rows, cf, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int cf_pad = (cf + KC - 1) / KC * KC;
  const size_t smem = sizeof(float) *
      ((size_t)BJ * (cf_pad + 4) + BI * FIS + BI * SSS + BI * CE);
  err = cudaFuncSetAttribute(pcm_fused_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((hw + BJ - 1) / BJ, n);
  pcm_fused_kernel<T><<<grid, NT, smem, stream>>>(cam, f, scale, out, hw, c, cf,
                                                   cf_pad, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// cam (n, hw, c) f32; f (n, hw, cf) f32 or bf16 (f_is_bf16); mask (n, hw) f32
// or null; scale (n, hw) f32 scratch; out (n, hw, c) f32. All contiguous, on
// the current device. Returns a cudaError_t (0 on success).
extern "C" int pcm_fused_launch(const float* cam, const void* f, int f_is_bf16,
                                const float* mask, float* scale, float* out,
                                int n, int hw, int c, int cf, float eps,
                                void* stream) {
  if (n < 1 || hw < 1 || cf < 1 || c < 1 || c > CE - 1 || n > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (f_is_bf16)
    return launch(cam, static_cast<const __nv_bfloat16*>(f), mask, scale, out, n,
                  hw, c, cf, eps, s);
  return launch(cam, static_cast<const float*>(f), mask, scale, out, n, hw, c,
                cf, eps, s);
}
