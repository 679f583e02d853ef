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
// ratio. At the main path's shape (16 views, hw = 12288, Cf = 192, C = 21)
// that is 1.029 TFLOP: 1.04 ms at the bf16 tensor-core peak (989 TFLOP/s),
// 15.4 ms at the f32 CUDA-core peak (67 TFLOP/s). Two variants, chosen by
// kernels/pcm_cuda.py:pcm_variant before the launch:
//
//   * bf16 features (the main path), on the tensor cores:
//       - pcm_prep_kernel, one warp per pixel: fn = bf16(mask * f / (||f|| +
//         eps)), zero-padded to a multiple of 64 channels -- the TPU kernel's
//         rounding rule, which normalizes in f's dtype -- and V =
//         [cam | 1 | 0 ...], 24 channels, as bf16 hi and lo parts;
//       - pcm_mma_kernel, the FlashAttention-2 form with j as the query and
//         neither a running max nor a rescale: see its note below.
//   * f32 features (the exactness path), f32 FMA on the CUDA cores:
//       - pcm_inv_norm_kernel: one warp per pixel computes scale_i =
//         mask_i / (||f_i|| + eps); the main kernel multiplies f by it on load.
//       - pcm_fused_kernel, grid (hw / BJ, N), 256 threads: the fn_j tile
//         (BJ x Cf) is loaded once into shared memory; for each row tile i
//         (BI rows), fn_i is staged through shared memory in K chunks of KC
//         channels and S = fn_i fn_j^T is accumulated in registers, a 4x4
//         block per thread (rows ti + 16r, cols tj + 16q, interleaved so that
//         shared-memory float4 reads do not conflict); relu(S) goes to shared
//         memory, next to the cam_i tile extended with a column of ones (so
//         the column sums come out of the same product as the propagation);
//         acc_j += relu(S)^T [cam_i | 1], each thread holding one column j
//         and six channels in registers.
//   * Tails of hw and Cf are zero-filled; nothing is padded in device memory
//     but the bf16 variant's own fn and V. C + 1 must fit in 24 channels.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

// ---- pcm_mma_kernel: bf16 features on the tensor cores -------------------

constexpr int MJ = 64;       // columns j per block: 4 warps x 16
constexpr int MI = 64;       // rows i per staged tile
constexpr int MSTAGES = 3;   // cp.async ring depth
constexpr int VC = 24;       // V = [cam | 1 | 0 ...]: C <= 23 channels, the ones column, padding

// fn = bf16(mask * f / (||f|| + eps)), zero-padded to cfp channels, and V =
// [cam | 1 | 0 ...] split into bf16 hi and lo parts (V ~ hi + lo to 2^-16),
// stored as one row of 2 * VC: hi, then lo. One warp per pixel.
__global__ void pcm_prep_kernel(const __nv_bfloat16* __restrict__ f,
                                const float* __restrict__ cam,
                                const float* __restrict__ mask,
                                __nv_bfloat16* __restrict__ fn,
                                __nv_bfloat16* __restrict__ v, long long rows, int cf,
                                int cfp, int c, float eps) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const __nv_bfloat16* fr = f + row * cf;
  float ss = 0.f;
  for (int k = lane; k < cf; k += 32) {
    const float x = __bfloat162float(fr[k]);
    ss = fmaf(x, x, ss);
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float den = sqrtf(ss) + eps;
  const float m = mask != nullptr ? mask[row] : 1.f;
  __nv_bfloat16* fo = fn + row * cfp;
  for (int k = lane; k < cfp; k += 32)
    fo[k] = __float2bfloat16(k < cf ? __bfloat162float(fr[k]) / den * m : 0.f);
  if (lane < VC) {
    const float x = lane < c ? cam[row * c + lane] : (lane == c ? 1.f : 0.f);
    const __nv_bfloat16 hi = __float2bfloat16(x);
    v[row * 2 * VC + lane] = hi;
    v[row * 2 * VC + VC + lane] = __float2bfloat16(x - __bfloat162float(hi));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// relu(a), relu(b) as bf16 hi parts (returned) and lo parts (in `lo`).
__device__ __forceinline__ uint32_t split_relu_bf16(float a, float b, uint32_t& lo) {
  a = fmaxf(a, 0.f);
  b = fmaxf(b, 0.f);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
  lo = pack_bf16(__floats2bfloat162_rn(a - __low2float(hi), b - __high2float(hi)));
  return pack_bf16(hi);
}

// Grid (ceil(hw / 64), n), 4 warps. Warp w owns columns j0 + 16w .. +15 and
// keeps their fn_j (16 x 16*KS) in registers as mma A fragments. The block
// walks all rows i in tiles of 64, staged (fn_i and V_i) through a 3-deep
// cp.async ring; per tile each warp computes S = fn_j fn_i^T (16 x 64) with
// mma.sync, relu's it in registers, re-packs the f32 accumulators as bf16 A
// fragments (two n8 accumulator tiles make one k16 fragment) and adds
// P V_i (16 x 24) into O. Column C of O is the column sum of P, so the
// epilogue is out_j = O[j, :C] / (O[j, C] + eps).
//
// S is exact for the bf16 fn (bf16 products, f32 sums). P V is not: one
// bf16 rounding of P and of cam errs by up to 2^-8 relative, which a sum
// over many i averages out but a column with a single contributing pixel
// does not (0.35% measured on the card at hw = 1, against rtol 0.2%). So P
// and V are each split into bf16 hi + lo and P V = Phi Vhi + Phi Vlo +
// Plo Vhi, about 2^-16 relative, for three times the small second product.
template <int KS>
__global__ void __launch_bounds__(128)
pcm_mma_kernel(const __nv_bfloat16* __restrict__ fn, const __nv_bfloat16* __restrict__ v,
               float* __restrict__ out, int hw, int c, float eps) {
  constexpr int CFP = 16 * KS;
  constexpr int FST = CFP + 8;  // fn row stride in shared memory: rows 16 bytes apart in banks
  constexpr int F_ELEMS = MI * FST;
  constexpr int STAGE = F_ELEMS + 2 * MI * VC;  // fn_i, then V_i hi and lo
  extern __shared__ __align__(16) __nv_bfloat16 msm[];

  const int n = blockIdx.y, j0 = blockIdx.x * MJ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* fb = fn + (size_t)n * hw * CFP;
  const __nv_bfloat16* vb = v + (size_t)n * hw * 2 * VC;

  // rows r0 .. r0 + 63 of fn (and V) into stage s; rows >= hw are zeros
  auto load_tile = [=](int s, int r0, bool with_v) {
    __nv_bfloat16* fs = msm + s * STAGE;
    for (int e = tid; e < MI * (CFP / 8); e += 128) {
      const int r = e / (CFP / 8), q = e - r * (CFP / 8);
      const bool ok = r0 + r < hw;
      cp_async16(fs + r * FST + q * 8, ok ? fb + (size_t)(r0 + r) * CFP + q * 8 : fb, ok);
    }
    if (with_v) {  // global row [hi | lo] -> shared tiles hi (MI x VC), then lo
      __nv_bfloat16* vs = fs + F_ELEMS;
      for (int e = tid; e < MI * (2 * VC / 8); e += 128) {
        const int r = e / (2 * VC / 8), q = e - r * (2 * VC / 8);
        const int part = q / (VC / 8), qq = q - part * (VC / 8);
        const bool ok = r0 + r < hw;
        cp_async16(vs + part * MI * VC + r * VC + qq * 8,
                   ok ? vb + (size_t)(r0 + r) * 2 * VC + q * 8 : vb, ok);
      }
    }
  };

  // fn_j -> registers
  uint32_t af[KS][4];
  load_tile(0, j0, false);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(af[ks], msm + (warp * 16 + (lane & 15)) * FST + ks * 16 + (lane >> 4) * 8);
  __syncthreads();

  const int n_tiles = (hw + MI - 1) / MI;
#pragma unroll
  for (int s = 0; s < MSTAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s * MI, true);
    cp_async_commit();
  }

  float o[3][4];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[q][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<MSTAGES - 2>();
    __syncthreads();  // tile it has landed; the stage of tile it - 1 is free
    const int nx = it + MSTAGES - 1;
    if (nx < n_tiles) load_tile(nx % MSTAGES, nx * MI, true);
    cp_async_commit();

    const __nv_bfloat16* fs = msm + (it % MSTAGES) * STAGE;
    const __nv_bfloat16* vs = fs + F_ELEMS;  // hi; lo follows at + MI * VC
    float s_acc[8][4];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[q][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];  // rows i = 16np .. 16np + 15, channels 16ks .. 16ks + 15
        ldsm_x4(r, fs + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * FST + ks * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(s_acc[2 * np], af[ks], r[0], r[1]);
        mma_bf16(s_acc[2 * np + 1], af[ks], r[2], r[3]);
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // rows i = 16kk .. 16kk + 15
      uint32_t p_hi[4], p_lo[4];
      p_hi[0] = split_relu_bf16(s_acc[2 * kk][0], s_acc[2 * kk][1], p_lo[0]);
      p_hi[1] = split_relu_bf16(s_acc[2 * kk][2], s_acc[2 * kk][3], p_lo[1]);
      p_hi[2] = split_relu_bf16(s_acc[2 * kk + 1][0], s_acc[2 * kk + 1][1], p_lo[2]);
      p_hi[3] = split_relu_bf16(s_acc[2 * kk + 1][2], s_acc[2 * kk + 1][3], p_lo[3]);
      const int vr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int part = 0; part < 2; ++part) {  // V hi, then V lo
        const __nv_bfloat16* vp = vs + part * MI * VC + vr * VC;
        uint32_t b01[4], b2[2];
        ldsm_x4_trans(b01, vp + (lane >> 4) * 8);  // channels 0 .. 15
        ldsm_x2_trans(b2, vp + 16);                // channels 16 .. 23
        mma_bf16(o[0], p_hi, b01[0], b01[1]);
        mma_bf16(o[1], p_hi, b01[2], b01[3]);
        mma_bf16(o[2], p_hi, b2[0], b2[1]);
        if (part == 0) {
          mma_bf16(o[0], p_lo, b01[0], b01[1]);
          mma_bf16(o[1], p_lo, b01[2], b01[3]);
          mma_bf16(o[2], p_lo, b2[0], b2[1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // o[q][e]: row g + 8 (e / 2), channel 8q + 2 (lane % 4) + e % 2. The
  // column sum (channel c) sits in lane 4g + (c % 8) / 2 of each quad.
  const int g = lane >> 2, t4 = lane & 3;
  // selects, not o[c / 8][...]: a runtime index would put o in local memory
  const bool odd = c & 1;
  const int cq = c >> 3;
  const float e0[3] = {odd ? o[0][1] : o[0][0], odd ? o[1][1] : o[1][0], odd ? o[2][1] : o[2][0]};
  const float e1[3] = {odd ? o[0][3] : o[0][2], odd ? o[1][3] : o[1][2], odd ? o[2][3] : o[2][2]};
  float d0 = cq == 0 ? e0[0] : (cq == 1 ? e0[1] : e0[2]);
  float d1 = cq == 0 ? e1[0] : (cq == 1 ? e1[1] : e1[2]);
  const int src = (lane & ~3) | ((c & 7) >> 1);
  d0 = __shfl_sync(0xffffffffu, d0, src) + eps;
  d1 = __shfl_sync(0xffffffffu, d1, src) + eps;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + warp * 16 + g + 8 * h;
    if (j >= hw) continue;
    const float den = h ? d1 : d0;
    float* ob = out + ((size_t)n * hw + j) * c;
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = 8 * q + 2 * t4 + e;
        if (ch < c) ob[ch] = o[q][2 * h + e] / den;
      }
  }
}

template <int KS>
int launch_mma(const __nv_bfloat16* fn, const __nv_bfloat16* v, float* out, int n, int hw,
               int c, float eps, cudaStream_t s) {
  const size_t smem = sizeof(__nv_bfloat16) * MSTAGES * (MI * (16 * KS + 8) + 2 * MI * VC);
  cudaError_t err = cudaFuncSetAttribute(pcm_mma_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pcm_mma_kernel<KS><<<dim3((hw + MJ - 1) / MJ, n), 128, smem, s>>>(fn, v, out, hw, c, eps);
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

// The tensor-core variant, bf16 features: cam (n, hw, c) f32; f (n, hw, cf)
// bf16; mask (n, hw) f32 or null; fn (n, hw, cfp) and v (n, hw, 48) bf16
// scratch, cfp = cf rounded up to 64 (64 .. 256); out (n, hw, c) f32. All
// contiguous, on the current device, fn and v 16-byte aligned. Returns a
// cudaError_t (0 on success).
extern "C" int pcm_mma_launch(const float* cam, const void* f, const float* mask, void* fn,
                              void* v, float* out, int n, int hw, int c, int cf, int cfp,
                              float eps, void* stream) {
  if (n < 1 || hw < 1 || cf < 1 || c < 1 || c > VC - 1 || n > 65535)
    return (int)cudaErrorInvalidValue;
  if (cfp % 64 != 0 || cfp < cf || cfp > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long rows = (long long)n * hw;
  auto* fnb = static_cast<__nv_bfloat16*>(fn);
  auto* vb = static_cast<__nv_bfloat16*>(v);
  pcm_prep_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(f), cam, mask, fnb, vb, rows, cf, cfp, c, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (cfp / 64) {
    case 1: return launch_mma<4>(fnb, vb, out, n, hw, c, eps, s);
    case 2: return launch_mma<8>(fnb, vb, out, n, hw, c, eps, s);
    case 3: return launch_mma<12>(fnb, vb, out, n, hw, c, eps, s);
    default: return launch_mma<16>(fnb, vb, out, n, hw, c, eps, s);
  }
}
