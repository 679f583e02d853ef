// K2: stride-1 SAME 3x3 convolution with dilation d (padding d), NHWC x HWIO
// -> NHWC, as a hand-written implicit GEMM for Hopper, sm_90a.
//
// Replaces the TPU kernel wseg_tpu/kernels/conv_pallas.py:conv3x3_dilated.
//
// GEMM view: M = B*H*W output pixels, N = CO, K = 9*CI. Row m of A is the
// dilated 3x3 neighbourhood of pixel m, gathered on load: for tap (dy, dx)
// and channel c, A[m, (3*dy + dx)*CI + c] = x[b, y + (dy-1)d, x + (dx-1)d, c],
// or 0 outside the image. B is the kernel as stored, (9*CI, CO) row-major.
// The K loop walks the 9 taps x CI chunks. Only the output is written to
// device memory: no padded copy of x, no shifted copies (the Pallas kernel
// needs three of them because Mosaic cannot slice a halo), no im2col matrix.
// Each block computes its own tap offsets and zero-fills the halo.
//
// Bound on the card: operations. At b7's shape (16 views of 96x128, 1024 ->
// 2048, d = 4) the conv is 2*9*196608*1024*2048 = 7.42 TFLOP, 7.5 ms at the
// H100's 989 TFLOP/s bf16 peak, against 1.25 GB of operands and output
// (0.37 ms at 3.35 TB/s). The design is therefore about feeding the tensor
// cores:
//   * bf16: 128x128 block tiles, K chunks of 32, 8 warps each owning 64x32
//     of the tile; mma.sync m16n8k16 (bf16 in, f32 accumulate) on operands
//     read with ldmatrix (.trans for B, which is stored K-major). A and B are
//     staged in shared memory with cp.async, 16 bytes a thread (src-size 0
//     zero-fills the halo and the channel tails), double-buffered so that
//     the next chunk's loads run under this chunk's MMAs. Rows are padded by
//     16 bytes so that ldmatrix reads hit distinct banks.
//   * f32 (the exactness path): the same block tile with f32 FMA on the CUDA
//     cores, 8x8 outputs a thread, no TF32.
// mma.sync reaches only part of the wgmma peak that the bound assumes; wgmma,
// TMA, warp specialisation and a deeper pipeline are later work.
//
// Tails: H and W (the halo), CI and CO are bounds-checked and zero-filled on
// load and masked on store; nothing is padded in device memory. When CI or
// CO is not a multiple of 8, or a pointer is not 16-byte aligned, the bf16
// kernel loads element by element instead of with cp.async. `tile_co`
// output channels go to one block, which walks them in 128-wide chunks.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;      // output pixels per block tile
constexpr int BN = 128;      // output channels per block tile
constexpr int NT = 256;      // threads per block (8 warps)
constexpr int BK = 32;       // K chunk, bf16
constexpr int AST = BK + 8;  // A row stride in shared memory (bf16): 80 bytes
constexpr int BST = BN + 8;  // B row stride (bf16): 272 bytes
constexpr int FBK = 16;      // K chunk, f32
constexpr int FST = BM + 4;  // f32 row stride (floats), both operands

struct Conv {
  int b, h, w, ci, co, d, m, tile_co;
};

// An output pixel; rows m >= M are marked invalid, so all their taps are halo.
struct Pix {
  int b, y, x;
  bool valid;
};

__device__ __forceinline__ Pix pixel(const Conv& p, int m) {
  Pix r{0, 0, 0, m < p.m};
  if (r.valid) {
    r.x = m % p.w;
    const int t = m / p.w;
    r.y = t % p.h;
    r.b = t / p.h;
  }
  return r;
}

// Element offset of x[b, y + (dy-1)d, x + (dx-1)d, 0], or -1 in the halo.
__device__ __forceinline__ long long tap_offset(const Conv& p, const Pix& q, int dy, int dx) {
  const long long iy = (long long)q.y + (long long)(dy - 1) * p.d;
  const long long ix = (long long)q.x + (long long)(dx - 1) * p.d;
  if (!q.valid || iy < 0 || iy >= p.h || ix < 0 || ix >= p.w) return -1;
  return (((long long)q.b * p.h + iy) * p.w + ix) * p.ci;
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16-byte global -> shared copy; with valid == false it writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the K chunk `kt` (tap kt / nci, channels (kt % nci) * BK ..) of the
// A tile (BM pixels) and the B tile (output channels n0 ..) into shared memory.
template <bool VEC>
__device__ __forceinline__ void load_chunk_bf16(
    __nv_bfloat16* a_s, __nv_bfloat16* b_s, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ k, const Conv& p, const Pix (&apix)[2],
    int m0, int n0, int kt, int nci, int tid) {
  const int tap = kt / nci, c0 = (kt - tap * nci) * BK;
  const int dy = tap / 3, dx = tap - dy * 3;
  if (VEC) {
    // A: rows ar and ar + 64, 8 channels at ac; B: rows br and br + 16, 8 at bc
    const int ar = tid >> 2, ac = (tid & 3) * 8;
    const int br = tid >> 4, bc = (tid & 15) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long off = tap_offset(p, apix[i], dy, dx);
      const bool ok = off >= 0 && c0 + ac < p.ci;
      cp_async16(a_s + (ar + 64 * i) * AST + ac, ok ? x + off + c0 + ac : x, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = br + 16 * i;
      const bool ok = c0 + r < p.ci && n0 + bc < p.co;
      const __nv_bfloat16* src = k + ((long long)tap * p.ci + c0 + r) * p.co + n0 + bc;
      cp_async16(b_s + r * BST + bc, ok ? src : k, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, c = e - r * BK;
      const long long off = tap_offset(p, pixel(p, m0 + r), dy, dx);
      a_s[r * AST + c] = (off >= 0 && c0 + c < p.ci) ? x[off + c0 + c] : zero;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int r = e / BN, c = e - r * BN;
      const bool ok = c0 + r < p.ci && n0 + c < p.co;
      b_s[r * BST + c] = ok ? k[((long long)tap * p.ci + c0 + r) * p.co + n0 + c] : zero;
    }
  }
}

// acc += A_chunk (warp rows wm..wm+63) x B_chunk (warp cols wn..wn+31).
__device__ __forceinline__ void mma_chunk_bf16(float (&acc)[4][4][4], const __nv_bfloat16* a_s,
                                               const __nv_bfloat16* b_s, int wm, int wn,
                                               int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    unsigned af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldsm_x4(af[mi], a_s + (wm + mi * 16 + (lane & 15)) * AST + kk + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      unsigned r[4];
      ldsm_x4_trans(r, b_s + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * BST + wn + nj * 16 +
                           (lane >> 4) * 8);
      bf[2 * nj][0] = r[0];
      bf[2 * nj][1] = r[1];
      bf[2 * nj + 1][0] = r[2];
      bf[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 2)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ k,
                    __nv_bfloat16* __restrict__ out, Conv p) {
  __shared__ __align__(16) __nv_bfloat16 a_s[2][BM * AST];
  __shared__ __align__(16) __nv_bfloat16 b_s[2][BK * BST];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int m0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * p.tile_co;
  const int co_end = min(co0 + p.tile_co, p.co);
  const int nci = (p.ci + BK - 1) / BK;
  const int kt_total = 9 * nci;
  Pix apix[2] = {pixel(p, m0 + (tid >> 2)), pixel(p, m0 + (tid >> 2) + 64)};

  for (int n0 = co0; n0 < co_end; n0 += BN) {
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

    load_chunk_bf16<VEC>(a_s[0], b_s[0], x, k, p, apix, m0, n0, 0, nci, tid);
    cp_async_commit();
    for (int kt = 0; kt < kt_total; ++kt) {
      if (kt + 1 < kt_total) {
        load_chunk_bf16<VEC>(a_s[(kt + 1) & 1], b_s[(kt + 1) & 1], x, k, p, apix, m0, n0,
                             kt + 1, nci, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      mma_chunk_bf16(acc, a_s[kt & 1], b_s[kt & 1], wm, wn, lane);
      __syncthreads();
    }

    // accumulator fragment: rows g and g + 8, columns t4 and t4 + 1
    const int g = lane >> 2, t4 = (lane & 3) * 2;
    const bool pairs = (p.co & 1) == 0;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + wm + mi * 16 + g + half * 8;
          if (m >= p.m || col >= co_end) continue;
          __nv_bfloat16* o = out + (long long)m * p.co + col;
          const float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
          if (pairs && col + 1 < co_end) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
          } else {
            o[0] = __float2bfloat16(v0);
            if (col + 1 < co_end) o[1] = __float2bfloat16(v1);
          }
        }
      }
  }
}

__global__ void __launch_bounds__(NT)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ k,
                   float* __restrict__ out, Conv p) {
  __shared__ __align__(16) float a_s[FBK * FST];  // A chunk transposed: [k][m]
  __shared__ __align__(16) float b_s[FBK * FST];  // B chunk: [k][n]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * p.tile_co;
  const int co_end = min(co0 + p.tile_co, p.co);
  const int nci = (p.ci + FBK - 1) / FBK;
  const int kt_total = 9 * nci;
  // loader roles: A row ar, channels ac..ac+7; B row br, columns bc..bc+7
  const int ar = tid >> 1, ac = (tid & 1) * 8;
  const int br = tid >> 4, bc = (tid & 15) * 8;
  const Pix apix = pixel(p, m0 + ar);

  for (int n0 = co0; n0 < co_end; n0 += BN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int kt = 0; kt < kt_total; ++kt) {
      const int tap = kt / nci, c0 = (kt - tap * nci) * FBK;
      const int dy = tap / 3, dx = tap - dy * 3;
      __syncthreads();  // the previous chunk has been read
      const long long off = tap_offset(p, apix, dy, dx);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + ac + j;
        a_s[(ac + j) * FST + ar] = (off >= 0 && c < p.ci) ? x[off + c] : 0.f;
      }
      const int kr = c0 + br;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + bc + j;
        b_s[br * FST + bc + j] =
            (kr < p.ci && n < p.co) ? k[((long long)tap * p.ci + kr) * p.co + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&a_s[kk * FST + ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&a_s[kk * FST + 64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&b_s[kk * FST + tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&b_s[kk * FST + 64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (m >= p.m) continue;
      float* o = out + (long long)m * p.co;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        if (n < co_end) o[n] = acc[i][j];
      }
    }
  }
}

}  // namespace

// x (b, h, w, ci), k (3, 3, ci, co), out (b, h, w, co): contiguous, on the
// current device, all float32 (is_bf16 == 0) or all bfloat16. vec != 0 (bf16
// only) needs ci % 8 == 0, co % 8 == 0 and 16-byte aligned x and k. Returns a
// cudaError_t (0 on success).
extern "C" int conv3x3_dilated_launch(const void* x, const void* k, void* out, int is_bf16,
                                      int vec, int b, int h, int w, int ci, int co, int d,
                                      int tile_co, void* stream) {
  if (b < 1 || h < 1 || w < 1 || ci < 1 || co < 1 || d < 1 || tile_co < 1)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)b * h * w;
  const long long grid_y = ((long long)co + tile_co - 1) / tile_co;
  if (m > INT_MAX - BM || grid_y > 65535) return (int)cudaErrorInvalidValue;
  if (vec && (!is_bf16 || ci % 8 != 0 || co % 8 != 0)) return (int)cudaErrorInvalidValue;
  const Conv p{b, h, w, ci, co, d, (int)m, tile_co};
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)grid_y);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    conv3x3_f32_kernel<<<grid, NT, 0, s>>>(static_cast<const float*>(x),
                                           static_cast<const float*>(k),
                                           static_cast<float*>(out), p);
  } else if (vec) {
    conv3x3_bf16_kernel<true><<<grid, NT, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                  static_cast<const __nv_bfloat16*>(k),
                                                  static_cast<__nv_bfloat16*>(out), p);
  } else {
    conv3x3_bf16_kernel<false><<<grid, NT, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                   static_cast<const __nv_bfloat16*>(k),
                                                   static_cast<__nv_bfloat16*>(out), p);
  }
  return (int)cudaGetLastError();
}
