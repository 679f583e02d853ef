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
// cores. Three kernels, chosen by kernels/conv_cuda.py:conv_variant before
// the launch:
//   * conv3x3_wgmma_kernel (bf16, CI and CO multiples of 8, 16-byte aligned
//     x): the Hopper form. An M tile is a th x tw rectangle of 128 output
//     pixels of one image. x is a 4-D TMA tensor (CI, W, H, B); the A tile
//     of tap (dy, dx) and channels c0..c0+63 is ONE cp.async.bulk.tensor at
//     the signed coordinates (c0, x0 + (dx-1)d, y0 + (dy-1)d, b), and TMA's
//     zero fill of out-of-bounds elements is the halo and the channel tail:
//     no thread computes an address. B is a K-major copy of the kernel,
//     (CO, 9, CI), written by the wrapper, so both operands are K-major
//     128-byte-swizzled tiles with the same wgmma descriptor. One producer
//     warp keeps a 4-stage ring (16 KB of A + BN x 128 B of B a stage) full;
//     two consumer warpgroups each run wgmma m64nBNk16 on their 64-row half,
//     f32 accumulators in registers (setmaxnreg moves registers from the
//     producer to them), keep one step's products in flight and hand the
//     step before back through an mbarrier. The epilogue rounds to bf16 and
//     stores straight from the registers. Persistent: one block per SM walks
//     the tiles, pixel tiles fastest, so the ring runs on across tiles and
//     every block in flight reads the same slice of the kernel.
//   * conv3x3_bf16_kernel (every other bf16 shape): 128x128 block tiles, K
//     chunks of 32, 8 warps each owning 64x32 of the tile; mma.sync m16n8k16
//     on operands read with ldmatrix (.trans for B, stored K-major), staged
//     with cp.async (src-size 0 zero-fills the halo and the channel tails;
//     element-wise loads when CI or CO is not a multiple of 8 or a pointer
//     is not 16-byte aligned), double-buffered, rows padded by 16 bytes so
//     that ldmatrix reads hit distinct banks.
//   * conv3x3_f32_kernel (f32, exact: no TF32): FMA on the CUDA cores, bound
//     by operations at 67 TFLOP/s (b7's crop-448 training shape, 8 x 56 x 56,
//     1024 -> 2048: 947 GFLOP, 14.1 ms, against 0.38 GB of operands and
//     output). NHWC; a 4-stage cp.async ring, one barrier a chunk, 128 x
//     128 block tiles of 8 x 8 outputs a thread (its own note below). Its
//     input gradient is the same kernel at dilation -d; its weight gradient
//     is conv3x3_wgrad_f32_kernel, of the same design (its own note below).
//
// Tails: H and W (the halo), CI and CO are zero-filled on load and masked on
// store; nothing is padded in device memory. `tile_co` output channels go to
// one block, which walks them in N-wide steps (wgmma: N = 64, 128 or 256;
// mma.sync and f32: 128).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;      // output pixels per block tile
constexpr int BN = 128;      // output channels per block tile
constexpr int NT = 256;      // threads per block (8 warps)
constexpr int BK = 32;       // K chunk, bf16
constexpr int AST = BK + 8;  // A row stride in shared memory (bf16): 80 bytes
constexpr int BST = BN + 8;  // B row stride (bf16): 272 bytes

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

using namespace hopper;

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
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldsm_x4(af[mi], a_s + (wm + mi * 16 + (lane & 15)) * AST + kk + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t r[4];
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

// ---- conv3x3_f32_kernel ----------------------------------------------------
//
// f32 FMA on the CUDA cores, no TF32: the exactness path, and the trunk's
// dilation-4 convs in training (models/layers.py sends them here, its
// channels_last tensors read as NHWC).
//
// Block tile 128 pixels x 128 output channels, K chunks of 16 (one tap, 16
// channels), 256 threads of 8 x 8 outputs each. A ring of F_STAGES chunks in
// shared memory is filled with cp.async, so the loads of the next chunks are
// in flight while a chunk's products run; one barrier a chunk. One 16-byte
// cp.async holds four consecutive channels of one pixel (element-wise when CI
// is no multiple of 4), and src-size 0 zero-fills the halo and the channel
// tail, so the A tile lands as [m][k] (rows padded to 20 floats). One
// iteration ahead of the products, the threads transpose it into one of two
// [k][m] buffers (rows padded to 132 floats): two conflict-free float4 reads
// and eight conflict-free scalar writes each. The products read it with
// float4 along the pixels. B is the kernel as (9 * CI, CO) rows, loaded as
// float4 along CO (element-wise when CO or tile_co is no multiple of 4).
// Warps are 2 x 4 over the tile (64 x 32 each), lanes 8 x 4; a thread owns
// pixels in runs of 4 and channels in runs of 4, stored as float4 along the
// channels.

constexpr int F_BM = 128;                // output pixels per block tile
constexpr int F_BN = 128;                // output channels per block tile
constexpr int F_BK = 16;                 // K chunk: channels of one tap
constexpr int F_STAGES = 4;              // cp.async ring depth
constexpr int F_NT = 256;                // threads per block
// Two blocks an SM cap a thread at 128 registers (a few spills); on the card
// that ran 4-7% faster at b6 / b7's crop-448 shapes than one block without.
constexpr int F_MIN_BLOCKS = 2;
constexpr int F_AST = F_BM + 4;          // [k][m] A row stride (floats)
constexpr int F_MST = F_BK + 4;          // staged [m][k] A row stride (floats)
constexpr int F_A = F_BM * F_MST;        // floats of A a stage
constexpr int F_STAGE = F_A + F_BK * F_BN;  // floats a stage, A then B
constexpr int F_BYTES = (F_STAGES * F_STAGE + 2 * F_BK * F_AST) * 4;  // + two [k][m]

// Element offset of x at the tap (dy, dx) of pixel q, channel 0, or -1 in the
// halo.
__device__ __forceinline__ long long f32_tap(const Conv& p, const Pix& q, int dy, int dx) {
  const int iy = q.y + (dy - 1) * p.d, ix = q.x + (dx - 1) * p.d;
  if (!q.valid || iy < 0 || iy >= p.h || ix < 0 || ix >= p.w) return -1;
  return (((long long)q.b * p.h + iy) * p.w + ix) * p.ci;
}

// Stage chunk kt (tap kt / nci, channels (kt % nci) * F_BK ..) of the A tile
// and of the B tile (output channels n0 ..). A: channels 4 (tid % 4) .. + 3
// of the thread's 2 pixels, m0 + tid / 4 + 64 e (e = 0, 1). B: rows kr and
// kr + 8 (kr = tid / 32) of columns 4 (tid % 32) .. + 3.
template <bool VA, bool VB>
__device__ __forceinline__ void f32_load(float* a_s, float* b_s, const float* __restrict__ x,
                                         const float* __restrict__ k, const Conv& p,
                                         const Pix (&pix)[2], int n0, int kt, int nci,
                                         int tid) {
  const int tap = kt / nci, c0 = (kt - tap * nci) * F_BK;
  const int dy = tap / 3, dx = tap - dy * 3;
  const int r = tid >> 2, q = (tid & 3) * 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long off = f32_tap(p, pix[i], dy, dx);
    float* dst = a_s + (r + 64 * i) * F_MST + q;
    if (VA) {
      const bool ok = off >= 0 && c0 + q < p.ci;
      cp_async16(dst, ok ? x + off + c0 + q : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = off >= 0 && c0 + q + e < p.ci;
        cp_async4(dst + e, ok ? x + off + c0 + q + e : x, ok);
      }
    }
  }
  const int kr = tid >> 5, bc = (tid & 31) * 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kr + 8 * i;
    const float* src = k + ((long long)tap * p.ci + c0 + row) * p.co + n0 + bc;
    float* dst = b_s + row * F_BN + bc;
    if (VB) {
      const bool ok = c0 + row < p.ci && n0 + bc < p.co;
      cp_async16(dst, ok ? src : k, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = c0 + row < p.ci && n0 + bc + e < p.co;
        cp_async4(dst + e, ok ? src + e : k, ok);
      }
    }
  }
}

// The staged [m][k] A tile into a [k][m] buffer: thread tid moves pixel
// tid % 128, channels 8 (tid / 128) .. + 7.
__device__ __forceinline__ void f32_transpose(float* km, const float* mk, int tid) {
  const int r = tid & 127, c = (tid >> 7) * 8;
  const float4 v0 = *reinterpret_cast<const float4*>(mk + r * F_MST + c);
  const float4 v1 = *reinterpret_cast<const float4*>(mk + r * F_MST + c + 4);
  float* o = km + c * F_AST + r;
  o[0] = v0.x;
  o[F_AST] = v0.y;
  o[2 * F_AST] = v0.z;
  o[3 * F_AST] = v0.w;
  o[4 * F_AST] = v1.x;
  o[5 * F_AST] = v1.y;
  o[6 * F_AST] = v1.z;
  o[7 * F_AST] = v1.w;
}

// acc += the chunk's products. Thread (lm, ln) of its warp's 64 x 32 tile at
// (wm, wn): acc[4 h + e][4 g + j] is pixel wm + 32 h + 4 lm + e, column wn +
// 16 g + 4 ln + j (h, g = 0, 1; e, j = 0 .. 3).
__device__ __forceinline__ void f32_chunk(float (&acc)[8][8], const float* a_s,
                                          const float* b_s, int wm, int wn, int lm, int ln) {
  const float* ap = a_s + wm + 4 * lm;
  const float* bp = b_s + wn + 4 * ln;
#pragma unroll
  for (int kk = 0; kk < F_BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(ap + kk * F_AST);
    const float4 a1 = *reinterpret_cast<const float4*>(ap + kk * F_AST + 32);
    const float4 b0 = *reinterpret_cast<const float4*>(bp + kk * F_BN);
    const float4 b1 = *reinterpret_cast<const float4*>(bp + kk * F_BN + 16);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <bool VA, bool VB>
__global__ void __launch_bounds__(F_NT, F_MIN_BLOCKS)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ k,
                   float* __restrict__ out, Conv p) {
  extern __shared__ __align__(16) float f32_ring[];
  float* const km = f32_ring + F_STAGES * F_STAGE;  // [k][m] buffers 0 and 1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int lm = lane & 7, ln = lane >> 3;
  const int m0 = blockIdx.x * F_BM;
  const int co0 = blockIdx.y * p.tile_co;
  const int co_end = min(co0 + p.tile_co, p.co);
  const int nci = (p.ci + F_BK - 1) / F_BK;
  const int kt_total = 9 * nci;

  Pix pix[2];  // the pixels this thread loads
#pragma unroll
  for (int e = 0; e < 2; ++e) pix[e] = pixel(p, m0 + (tid >> 2) + 64 * e);

  for (int n0 = co0; n0 < co_end; n0 += F_BN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    __syncthreads();  // the previous N step's last chunk has been read
#pragma unroll
    for (int s = 0; s < F_STAGES - 1; ++s) {
      if (s < kt_total)
        f32_load<VA, VB>(f32_ring + s * F_STAGE, f32_ring + s * F_STAGE + F_A, x, k, p, pix,
                         n0, s, nci, tid);
      cp_async_commit();
    }
    cp_async_wait<F_STAGES - 2>();  // chunk 0 into [k][m] buffer 0
    __syncthreads();
    f32_transpose(km, f32_ring, tid);
    for (int kt = 0; kt < kt_total; ++kt) {
      // chunk kt + 1 has landed (this thread's copies) ...
      cp_async_wait<F_STAGES - 3>();
      // ... everyone's; chunk kt - 1 has been read and chunk kt is in its
      // [k][m] buffer
      __syncthreads();
      if (kt + 1 < kt_total)
        f32_transpose(km + ((kt + 1) & 1) * F_BK * F_AST,
                      f32_ring + ((kt + 1) % F_STAGES) * F_STAGE, tid);
      const int next = kt + F_STAGES - 1;
      if (next < kt_total) {
        float* st = f32_ring + (next % F_STAGES) * F_STAGE;
        f32_load<VA, VB>(st, st + F_A, x, k, p, pix, n0, next, nci, tid);
      }
      cp_async_commit();
      f32_chunk(acc, km + (kt & 1) * F_BK * F_AST,
                f32_ring + (kt % F_STAGES) * F_STAGE + F_A, wm, wn, lm, ln);
    }
    cp_async_wait<0>();

    // float4 stores: 4 channels (n a multiple of 4)
    const bool vec = p.co % 4 == 0 && p.tile_co % 4 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mb = m0 + wm + 32 * h + 4 * lm;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int nb = n0 + wn + 16 * g + 4 * ln;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = mb + e;
          if (m >= p.m) continue;
          float* o = out + (long long)m * p.co + nb;
          const float* v = acc[4 * h + e] + 4 * g;
          if (vec && nb + 3 < co_end) {
            *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (nb + j < co_end) o[j] = v[j];
          }
        }
      }
    }
  }
}

// ---- conv3x3_wgrad_f32_kernel ----------------------------------------------
//
// The weight gradient of conv3x3_f32_kernel's conv, in exact f32:
//   dW[co, ci, ty, tx] = sum over pixels p of x[p + ((ty-1)d, (tx-1)d), ci] * g[p, co]
// with g the output's gradient, both NHWC. It replaces no TPU kernel (the
// JAX package leaves K2's gradient to XLA); it was added because cuDNN's f32
// weight gradient of the trunk's dilation-4 convs runs at ~35 TFLOP/s on an
// H100, where this design reaches ~46 (PERF.md). The input gradient needs no
// kernel of its own: it is conv3x3_f32_kernel at dilation -d (the taps'
// offsets negated, the kernel rotated 180 degrees) on the kernel's (3, 3,
// CO, CI) rows.
//
// GEMM view: M = 9 taps x CI, N = CO, K = the B*H*W pixels. Bound:
// operations, 2 * 9 * CI * CO * B * H * W at 67 TFLOP/s (b7's crop-448
// training shape: 947 GFLOP, 14.1 ms, against 0.31 GB of operands and
// 75.5 MB of output), so the design is the forward's, fed the same way: a
// block tile of 128 channels of one tap x 128 output channels, K chunks of 16
// pixels in a 4-stage cp.async ring with one barrier a chunk, and the
// forward's 8 x 8 FMA micro-tile (f32_chunk). Both operands are NHWC, so a
// chunk's A rows (16 pixels, shifted by the tap, 128 channels each) and B
// rows (the same 16 pixels' 128 output channels) each load as 16-byte
// cp.async along the channels and land as [k][m] and [k][n]: no transpose.
// src-size 0 zero-fills the halo, the pixel tail and the channel tails.
// Each thread tracks its two pixel rows' (b, y, x), advanced a chunk at a
// time, so no division runs in the loop. The epilogue writes dW in its
// torch layout, (CO, CI, 3, 3), straight from the registers.
//
// Wave quantisation: the tiles are 9 ceil(CI/128) x ceil(CO/128) (b6 at crop
// 448: 288, against 264 block slots on 132 SMs). `split` > 1 cuts the pixel
// reduction into that many equal ranges (blockIdx.z): range 0 writes dW, the
// others write partials, and a second pass adds them to dW in range order,
// so a run repeats bit for bit.

constexpr int W_BK = 16;                  // K chunk: pixels
constexpr int W_A = W_BK * F_AST;         // floats of A a stage, [k][m]
constexpr int W_STAGE = W_A + W_BK * F_BN;  // floats a stage, A then B
constexpr int W_BYTES = F_STAGES * W_STAGE * 4;

struct Wgrad {
  int h, w, ci, co, d, pixels, ci_tiles, chunks;  // chunks: K chunks of one range
};

// Stage one K chunk: rows r and r + 8 (r = tid / 32) of A (x at the row's
// pixel shifted by (oy, ox), channels ci0 + 4 (tid % 32) .. + 3) and of B (g
// at the pixel, output channels n0 + 4 (tid % 32) .. + 3). A pixel at or past
// `end` is zero in both.
template <bool VA, bool VB>
__device__ __forceinline__ void wgrad_load(float* a_s, float* b_s, const float* __restrict__ x,
                                           const float* __restrict__ g, const Wgrad& p,
                                           const int (&pix)[2], const int (&pb)[2],
                                           const int (&py)[2], const int (&px)[2], int end,
                                           int oy, int ox, int ci0, int n0, int tid) {
  const int r = tid >> 5, c = (tid & 31) * 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = pix[i] < end;
    const int sy = py[i] + oy, sx = px[i] + ox;
    const bool ok_a = in && sy >= 0 && sy < p.h && sx >= 0 && sx < p.w;
    const float* src_a = x + ((((long long)pb[i] * p.h + sy) * p.w + sx) * p.ci + ci0 + c);
    float* dst_a = a_s + (r + 8 * i) * F_AST + c;
    const float* src_b = g + ((long long)pix[i] * p.co + n0 + c);
    float* dst_b = b_s + (r + 8 * i) * F_BN + c;
    if (VA) {
      const bool ok = ok_a && ci0 + c < p.ci;
      cp_async16(dst_a, ok ? src_a : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = ok_a && ci0 + c + e < p.ci;
        cp_async4(dst_a + e, ok ? src_a + e : x, ok);
      }
    }
    if (VB) {
      const bool ok = in && n0 + c < p.co;
      cp_async16(dst_b, ok ? src_b : g, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = in && n0 + c + e < p.co;
        cp_async4(dst_b + e, ok ? src_b + e : g, ok);
      }
    }
  }
}

// The thread's two pixel rows, one chunk on.
__device__ __forceinline__ void wgrad_advance(const Wgrad& p, int (&pix)[2], int (&pb)[2],
                                              int (&py)[2], int (&px)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    pix[i] += W_BK;
    px[i] += W_BK;
    while (px[i] >= p.w) {
      px[i] -= p.w;
      if (++py[i] == p.h) {
        py[i] = 0;
        ++pb[i];
      }
    }
  }
}

// Block (tap ci-tile, co tile, range): blockIdx.x = tap * ci_tiles + ci tile.
template <bool VA, bool VB>
__global__ void __launch_bounds__(F_NT, F_MIN_BLOCKS)
conv3x3_wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         float* __restrict__ dw, float* __restrict__ parts, Wgrad p) {
  extern __shared__ __align__(16) float wgrad_ring[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int lm = lane & 7, ln = lane >> 3;
  const int tap = blockIdx.x / p.ci_tiles;
  const int ci0 = (blockIdx.x - tap * p.ci_tiles) * F_BM;
  const int n0 = blockIdx.y * F_BN;
  const int oy = (tap / 3 - 1) * p.d, ox = (tap % 3 - 1) * p.d;
  const long long begin = (long long)blockIdx.z * p.chunks * W_BK;
  const int end = (int)min((long long)p.pixels, begin + (long long)p.chunks * W_BK);
  const int kt_total = end > begin ? (int)((end - begin + W_BK - 1) / W_BK) : 0;

  int pix[2], pb[2], py[2], px[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    pix[i] = (int)begin + (tid >> 5) + 8 * i;
    px[i] = pix[i] % p.w;
    const int t = pix[i] / p.w;
    py[i] = t % p.h;
    pb[i] = t / p.h;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < kt_total) {
      wgrad_load<VA, VB>(wgrad_ring + s * W_STAGE, wgrad_ring + s * W_STAGE + W_A, x, g, p, pix,
                         pb, py, px, end, oy, ox, ci0, n0, tid);
      wgrad_advance(p, pix, pb, py, px);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_total; ++kt) {
    cp_async_wait<F_STAGES - 2>();  // chunk kt has landed (this thread's copies) ...
    __syncthreads();                // ... everyone's; chunk kt - 1 has been read
    const int next = kt + F_STAGES - 1;
    if (next < kt_total) {
      float* st = wgrad_ring + (next % F_STAGES) * W_STAGE;
      wgrad_load<VA, VB>(st, st + W_A, x, g, p, pix, pb, py, px, end, oy, ox, ci0, n0, tid);
      wgrad_advance(p, pix, pb, py, px);
    }
    cp_async_commit();
    const float* st = wgrad_ring + (kt % F_STAGES) * W_STAGE;
    f32_chunk(acc, st, st + W_A, wm, wn, lm, ln);
  }
  cp_async_wait<0>();

  // acc[4 h + e][4 g + j]: channel ci0 + wm + 32 h + 4 lm + e, output
  // channel n0 + wn + 16 g + 4 ln + j; dW[co][ci][tap]
  float* out = blockIdx.z == 0 ? dw : parts + (long long)(blockIdx.z - 1) * p.co * p.ci * 9;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = ci0 + wm + 32 * h + 4 * lm + e;
      if (ci >= p.ci) continue;
#pragma unroll
      for (int gg = 0; gg < 2; ++gg)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = n0 + wn + 16 * gg + 4 * ln + j;
          if (co < p.co) out[((long long)co * p.ci + ci) * 9 + tap] = acc[4 * h + e][4 * gg + j];
        }
    }
}

// dw[i] += parts[0][i] + parts[1][i] + ..., in that order.
__global__ void wgrad_sum_kernel(float* __restrict__ dw, const float* __restrict__ parts,
                                 long long n, int nparts) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = dw[i];
    for (int s = 0; s < nparts; ++s) v += parts[s * n + i];
    dw[i] = v;
  }
}

// ---- conv3x3_wgmma_kernel ------------------------------------------------

constexpr int WG_BM = 128;          // output pixels per tile (th x tw)
constexpr int WG_BK = 64;           // channels per K step: one 128-byte swizzle row
constexpr int WG_STAGES = 4;        // TMA ring depth
constexpr int WG_THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;

template <int N>
struct WgTile {
  static constexpr int B_BYTES = N * WG_BK * 2;
  static constexpr int STAGE_BYTES = WG_A_BYTES + B_BYTES;
  // ring + barriers + slack to align the ring to 1024 bytes (128B swizzle)
  static constexpr int SMEM = WG_STAGES * STAGE_BYTES + 2 * WG_STAGES * 8 + 1024;
};

struct WgConv {
  int h, w, co, d, tile_co, tw, tiles_w, tiles_h, n_groups, nci, tiles;
};

// Tile t: channel group t / (pixel tiles), then the pixel tile in row-major
// order over (b, tile row, tile column), so the blocks in flight share one
// group's slice of the kernel and walk the pixels.
struct WgTileAt {
  int b, x0, y0, co0, co_end;
};

__device__ __forceinline__ WgTileAt wg_tile(const WgConv& p, int t) {
  WgTileAt r;
  const int n_pix = p.tiles / p.n_groups;
  const int group = t / n_pix;
  t -= group * n_pix;
  const int tx = t % p.tiles_w;
  t /= p.tiles_w;
  const int ty = t % p.tiles_h;
  r.b = t / p.tiles_h;
  r.x0 = tx * p.tw;
  r.y0 = ty * (WG_BM / p.tw);
  r.co0 = group * p.tile_co;
  r.co_end = min(r.co0 + p.tile_co, p.co);
  return r;
}

// Persistent: one block per SM walks tiles blockIdx.x, + gridDim.x, ... The
// ring runs on across tiles, so the producer loads the next tile while the
// consumers store this one. The blocks in flight at any time hold
// consecutive tiles: ~132 pixel tiles of one channel group, so every block
// streams the same slice of the kernel (4.7 MB at b7's shape) from L2, and
// x, whose taps overlap between neighbouring tiles, once per group from
// device memory. This order beat the channel groups fastest (x once, the
// whole 37.7 MB kernel in L2) by 8-14% on the card.
template <int N>
__global__ void __launch_bounds__(WG_THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap kmap,
                     __nv_bfloat16* __restrict__ out, WgConv p) {
  using T = WgTile<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + WG_STAGES;
  const int k_steps = 9 * p.nci;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread walks (tile, N step, tap, channel chunk) and keeps
    // the ring full; the other 127 threads of the warpgroup leave.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const WgTileAt q = wg_tile(p, tile);
        for (int n0 = q.co0; n0 < q.co_end; n0 += N) {
          for (int kt = 0; kt < k_steps; ++kt) {
            const int tap = kt / p.nci;
            const int c0 = (kt - tap * p.nci) * WG_BK;
            const int dy = tap / 3, dx = tap - 3 * (tap / 3);
            mbar_wait(&empty[stage], phase);
            uint8_t* a = ring + stage * T::STAGE_BYTES;
            mbar_arrive_expect_tx(&full[stage], T::STAGE_BYTES);
            tma_load_4d(a, &xmap, &full[stage], c0, q.x0 + (dx - 1) * p.d,
                        q.y0 + (dy - 1) * p.d, q.b);
            tma_load_3d(a + WG_A_BYTES, &kmap, &full[stage], c0, tap, n0);
            if (++stage == WG_STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns rows 64*cw .. 64*cw + 63 of each tile
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    if (t == 0)
      for (int s = 0; s < WG_STAGES; ++s) mbar_arrive(&empty[s]);  // the ring starts empty
    const int warp = t >> 5, lane = t & 31;
    const int r0 = cw * 64 + warp * 16 + (lane >> 2);  // this thread's rows: r0, r0 + 8

    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const WgTileAt q = wg_tile(p, tile);
      long long row_off[2];
      bool row_ok[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        const int y = q.y0 + r / p.tw, x = q.x0 + r % p.tw;
        row_ok[half] = y < p.h && x < p.w;
        row_off[half] = (((long long)q.b * p.h + y) * p.w + x) * p.co;
      }

      for (int n0 = q.co0; n0 < q.co_end; n0 += N) {
        float acc[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
        for (int kt = 0; kt < k_steps; ++kt) {
          mbar_wait(&full[stage], phase);
          const uint8_t* a = ring + stage * T::STAGE_BYTES;
          const uint64_t da = wgmma_desc_sw128(a + cw * 64 * 128);
          const uint64_t db = wgmma_desc_sw128(a + WG_A_BYTES);
          wgmma_fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < WG_BK / 16; ++k) wgmma_bf16<N>(acc, da + 2 * k, db + 2 * k, 1);
          wgmma_commit();
          // this step's products stay in flight; the previous step's are
          // done, so its stage goes back to the producer
          wgmma_wait<1>();
          wgmma_fence_acc(acc);
          if (kt > 0 && t == 0) mbar_arrive(&empty[prev]);
          prev = stage;
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        wgmma_fence_acc(acc);
        if (t == 0) mbar_arrive(&empty[prev]);

        // accumulator fragment: acc[4j + 2h + e] is row r0 + 8h, column
        // n0 + 8j + 2(lane % 4) + e
        const int nb = n0 + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int col = nb + 8 * j;
          if (col >= q.co_end) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (!row_ok[half]) continue;
            __nv_bfloat16* o = out + row_off[half] + col;
            const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
            if (col + 1 < q.co_end) {
              *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
            } else {
              o[0] = __float2bfloat16(v0);
            }
          }
        }
      }
    }
  }
}

}  // namespace

// bf16 x (b, h, w, ci), k (3, 3, ci, co), out (b, h, w, co): contiguous, on
// the current device. vec != 0 needs ci % 8 == 0, co % 8 == 0 and 16-byte
// aligned x and k. Returns a cudaError_t (0 on success).
extern "C" int conv3x3_bf16_launch(const void* x, const void* k, void* out, int vec, int b,
                                   int h, int w, int ci, int co, int d, int tile_co,
                                   void* stream) {
  if (b < 1 || h < 1 || w < 1 || ci < 1 || co < 1 || d < 1 || tile_co < 1)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)b * h * w;
  const long long grid_y = ((long long)co + tile_co - 1) / tile_co;
  if (m > INT_MAX - BM || grid_y > 65535) return (int)cudaErrorInvalidValue;
  if (vec && (ci % 8 != 0 || co % 8 != 0)) return (int)cudaErrorInvalidValue;
  const Conv p{b, h, w, ci, co, d, (int)m, tile_co};
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)grid_y);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
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

namespace {

template <bool VA, bool VB>
int launch_f32(const float* x, const float* k, float* out, const Conv& p, dim3 grid,
               cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(conv3x3_f32_kernel<VA, VB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               F_BYTES);
  if (err != cudaSuccess) return (int)err;
  conv3x3_f32_kernel<VA, VB><<<grid, F_NT, F_BYTES, s>>>(x, k, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 x (b, h, w, ci), k (3, 3, ci, co), i.e. (9 ci, co) rows, out (b, h, w,
// co): contiguous, on the current device. vec_a != 0 loads x as 16-byte
// chunks: it needs ci % 4 == 0 and a 16-byte aligned x. vec_b != 0 needs
// co % 4 == 0, tile_co % 4 == 0 and a 16-byte aligned k; out is 16-byte
// aligned. d may be negative: tap (dy, dx) then reads x at ((dy-1)d,
// (dx-1)d), the conv with k rotated 180 degrees (the input gradient's conv).
// Returns a cudaError_t (0 on success).
extern "C" int conv3x3_f32_launch(const void* x, const void* k, void* out, int vec_a,
                                  int vec_b, int b, int h, int w, int ci, int co, int d,
                                  int tile_co, void* stream) {
  if (b < 1 || h < 1 || w < 1 || ci < 1 || co < 1 || d == 0 || tile_co < 1)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)b * h * w;
  const long long grid_y = ((long long)co + tile_co - 1) / tile_co;
  if (m > INT_MAX - F_BM || grid_y > 65535) return (int)cudaErrorInvalidValue;
  if (vec_a && ci % 4 != 0) return (int)cudaErrorInvalidValue;
  if (vec_b && (co % 4 != 0 || tile_co % 4 != 0)) return (int)cudaErrorInvalidValue;
  if ((vec_a && reinterpret_cast<uintptr_t>(x) % 16 != 0) ||
      (vec_b && reinterpret_cast<uintptr_t>(k) % 16 != 0) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const Conv p{b, h, w, ci, co, d, (int)m, tile_co};
  const dim3 grid((unsigned)((m + F_BM - 1) / F_BM), (unsigned)grid_y);
  const float* xf = static_cast<const float*>(x);
  const float* kf = static_cast<const float*>(k);
  float* of = static_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec_a && vec_b) return launch_f32<true, true>(xf, kf, of, p, grid, s);
  if (vec_a) return launch_f32<true, false>(xf, kf, of, p, grid, s);
  if (vec_b) return launch_f32<false, true>(xf, kf, of, p, grid, s);
  return launch_f32<false, false>(xf, kf, of, p, grid, s);
}

namespace {

template <bool VA, bool VB>
int launch_wgrad(const float* x, const float* g, float* dw, float* parts, const Wgrad& p,
                 dim3 grid, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_f32_kernel<VA, VB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               W_BYTES);
  if (err != cudaSuccess) return (int)err;
  conv3x3_wgrad_f32_kernel<VA, VB><<<grid, F_NT, W_BYTES, s>>>(x, g, dw, parts, p);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 x (b, h, w, ci), g (b, h, w, co) -- the output's gradient --, dw (co,
// ci, 3, 3): contiguous, on the current device. The pixel reduction is cut
// into `split` ranges; with split > 1, parts holds (split - 1) x co x ci x 9
// floats of scratch. vec_a != 0 loads x as 16-byte chunks: it needs ci % 4 ==
// 0 and a 16-byte aligned x; vec_b != 0 the same of g with co. Returns a
// cudaError_t (0 on success).
extern "C" int conv3x3_wgrad_f32_launch(const void* x, const void* g, void* dw, void* parts,
                                        int vec_a, int vec_b, int b, int h, int w, int ci,
                                        int co, int d, int split, void* stream) {
  if (b < 1 || h < 1 || w < 1 || ci < 1 || co < 1 || d < 1 || split < 1)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)b * h * w;
  const long long ci_tiles = (ci + F_BM - 1) / F_BM, co_tiles = (co + F_BN - 1) / F_BN;
  if (m > INT_MAX - 4 * W_BK || 9 * ci_tiles > INT_MAX || co_tiles > 65535 || split > 65535)
    return (int)cudaErrorInvalidValue;
  if ((vec_a && ci % 4 != 0) || (vec_b && co % 4 != 0) || (split > 1 && parts == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((vec_a && reinterpret_cast<uintptr_t>(x) % 16 != 0) ||
      (vec_b && reinterpret_cast<uintptr_t>(g) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const long long chunks = (m + W_BK - 1) / W_BK;
  const Wgrad p{h, w, ci, co, d, (int)m, (int)ci_tiles, (int)((chunks + split - 1) / split)};
  const dim3 grid((unsigned)(9 * ci_tiles), (unsigned)co_tiles, (unsigned)split);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* dwf = static_cast<float*>(dw);
  float* pf = static_cast<float*>(parts);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int err;
  if (vec_a && vec_b) err = launch_wgrad<true, true>(xf, gf, dwf, pf, p, grid, s);
  else if (vec_a) err = launch_wgrad<true, false>(xf, gf, dwf, pf, p, grid, s);
  else if (vec_b) err = launch_wgrad<false, true>(xf, gf, dwf, pf, p, grid, s);
  else err = launch_wgrad<false, false>(xf, gf, dwf, pf, p, grid, s);
  if (err != 0 || split == 1) return err;
  const long long n = (long long)co * ci * 9;
  const long long blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  wgrad_sum_kernel<<<(unsigned)blocks, 256, 0, s>>>(dwf, pf, n, split - 1);
  return (int)cudaGetLastError();
}

namespace {

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; it is fetched through the CUDA
// runtime, so the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first), 128-byte swizzle, zero
// fill out of bounds. Returns 0 or 1000 + the CUresult of the refusal.
int make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
             const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                            const_cast<void*>(base), dims, strides, box, ones,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

template <int N>
int launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& kmap, __nv_bfloat16* out,
                 const WgConv& p, cudaStream_t s) {
  const int smem = WgTile<N>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int blocks = p.tiles < sms ? p.tiles : sms;  // one block per SM (the ring fills it)
  conv3x3_wgmma_kernel<N><<<blocks, WG_THREADS, smem, s>>>(xmap, kmap, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 x (b, h, w, ci), kt (co, 3, 3, ci) -- the kernel K-major --, out (b,
// h, w, co): contiguous, on the current device, x and kt 16-byte aligned, ci
// and co multiples of 8. The M tile is (128 / tw) x tw pixels, tw in {16, 32,
// 64, 128}; tile_co output channels go to one block, in steps of N = 64 if
// tile_co <= 64, 128 if tile_co <= 128, else 256. Returns a cudaError_t (0 on
// success) or 1000 + the CUresult with which a TMA tensor map was refused.
extern "C" int conv3x3_wgmma_launch(const void* x, const void* kt, void* out, int b, int h,
                                    int w, int ci, int co, int d, int tile_co, int tw,
                                    void* stream) {
  if (b < 1 || h < 1 || w < 1 || ci < 1 || co < 1 || d < 1 || tile_co < 1)
    return (int)cudaErrorInvalidValue;
  if (ci % 8 != 0 || co % 8 != 0 || (tw != 16 && tw != 32 && tw != 64 && tw != 128))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(kt)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int n = tile_co <= 64 ? 64 : tile_co <= 128 ? 128 : 256;
  const int th = WG_BM / tw;
  const int tiles_w = (w + tw - 1) / tw, tiles_h = (h + th - 1) / th;
  const int n_groups = (co + tile_co - 1) / tile_co;
  const long long tiles = (long long)n_groups * tiles_w * tiles_h * b;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const WgConv p{h, w, co, d, tile_co, tw, tiles_w, tiles_h, n_groups, (ci + WG_BK - 1) / WG_BK,
                 (int)tiles};

  const cuuint64_t esz = 2;
  CUtensorMap xmap, kmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)ci, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t xstrides[3] = {esz * ci, esz * ci * w, esz * ci * w * h};
  const cuuint32_t xbox[4] = {WG_BK, (cuuint32_t)tw, (cuuint32_t)th, 1};
  int err = make_map(&xmap, x, 4, xdims, xstrides, xbox);
  if (err != 0) return err;
  const cuuint64_t kdims[3] = {(cuuint64_t)ci, 9, (cuuint64_t)co};
  const cuuint64_t kstrides[2] = {esz * ci, esz * ci * 9};
  const cuuint32_t kbox[3] = {WG_BK, 1, (cuuint32_t)n};
  err = make_map(&kmap, kt, 3, kdims, kstrides, kbox);
  if (err != 0) return err;

  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (n == 64) return launch_wgmma<64>(xmap, kmap, o, p, s);
  if (n == 128) return launch_wgmma<128>(xmap, kmap, o, p, s);
  return launch_wgmma<256>(xmap, kmap, o, p, s);
}
