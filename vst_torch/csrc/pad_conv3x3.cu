// Reflect-pad-1 + 3x3 convolution, the FastStyleNet residual-trunk conv, for
// Hopper (sm_90a), in the four cost modes of the TPU probes.
//
// Replaces the TPU kernels scripts/bisect_im2col.py:make (pallas_call :106;
// variants tap9 / im2col / ztrick / row3 all compute mode 0) and
// scripts/bisect_kernel_cost.py:make (pallas_call :59; modes full /
// mxu_only / shift_only / dma_only). With xp = reflect_pad_1(x):
//   0 full:       y[p] = sum_{dy,dx} xp[p + (dy,dx)] @ w[dy,dx]
//   1 mxu_only:   y[p] = sum_{dy,dx} xp[p] @ w[dy,dx]   (one unshifted tap)
//   2 shift_only: y[p] = sum_{dy,dx} xp[p + (dy,dx)]    (no product; C_out = C_in)
//   3 dma_only:   y[p] = xp[p]                          (C_out = C_in)
// x (N, H, W, C_in) and y (N, H, W, C_out) channels-last, w (3, 3, C_in,
// C_out) HWIO, all f32 or all bf16; sums in f32, y cast once at the end.
//
// Design: an implicit GEMM, M = pixels, K = 9*C_in, N = C_out. A CTA owns 4
// output rows x 32 output columns x 64 output channels. For each chunk of
// input channels it stages the (4+2) x (32+2) input halo in shared memory,
// resolving the reflection in the load index (row -1 -> 1, row H -> H-2,
// the same for columns): no padded copy is written to device memory, the
// counterpart of the TPU kernel's reflected-row DMAs and column concat.
// Rows and columns past the ragged edge (H = 109 = 27*4 + 1) are computed
// from clamped indices and masked at the store.
//   f32 (TF32 off): SIMT FMA. The halo is staged column-contiguous; a thread
//     owns 8 pixels of one row x 4 channels and reads the 10 halo columns
//     its 3 dx taps need once per (dy, channel).
//   bf16, modes 0 and 1: tensor cores through wmma 16x16x16 bf16 -> f32.
//     The halo is staged channel-contiguous, 16 channels a chunk, so the
//     16 pixels x 16 channels of one tap are a row-major A tile read in
//     place (a dx shift moves the tile by 32 bytes, which keeps wmma's
//     alignment); each warp owns 32 pixels x 32 channels.
//   bf16, modes 2 and 3: the SIMT path, converting to f32 at the load.
//
// Bound: operations. At the trunk shape (1, 109, 256, 128 -> 128) one conv
// is 8.23 GFLOP against 29 MB (f32) / 15 MB (bf16) moved: 0.123 ms at the
// 67 TFLOP/s SIMT f32 rate, 0.0083 ms at the 989 TFLOP/s bf16 tensor rate,
// and 0.009 / 0.004 ms of memory time at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

enum Mode { kFull = 0, kMxuOnly = 1, kShiftOnly = 2, kDmaOnly = 3 };

constexpr int kTileRows = 4;
constexpr int kTileCols = 32;
constexpr int kTileN = 64;
constexpr int kHaloRows = kTileRows + 2;
constexpr int kHaloCols = kTileCols + 2;
constexpr int kThreads = 256;
constexpr int kSimtChunk = 8;   // input channels staged per step, SIMT path
constexpr int kMmaChunk = 16;   // input channels staged per step, wmma path

struct Geometry {
  int height, width, cin, cout;  // cout: channels of y (and of w for modes 0, 1)
  int col_tiles;
};

// Reflection of padding 1; an index past the ragged edge (an output that is
// masked) is clamped into the image so that every load stays in bounds.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// two floats rounded to bf16, the first in the low half (the lower address)
__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
pad_conv3x3_simt(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                 Geometry g) {
  constexpr bool kWeighted = MODE == kFull || MODE == kMxuOnly;
  __shared__ float halo[kHaloRows][kSimtChunk][kHaloCols];
  __shared__ __align__(16) float wt[kWeighted ? 9 : 1][kSimtChunk][kTileN];

  const int r0 = (blockIdx.x / g.col_tiles) * kTileRows;
  const int c0 = (blockIdx.x % g.col_tiles) * kTileCols;
  const int n0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const int tn = tid % 16;              // channels n .. n+3
  const int prow = (tid / 16) / 4;      // one output row of the tile
  const int pcol = ((tid / 16) % 4) * 8;  // 8 output columns pcol .. pcol+7
  const int n = n0 + 4 * tn;
  const T* xb = x + (size_t)blockIdx.z * g.height * g.width * g.cin;

  float acc[8][4] = {};
  // modes 2 and 3 map input channel c to output channel c: only the chunks
  // of this CTA's channel tile are read
  const int k_begin = kWeighted ? 0 : n0;
  const int k_end = kWeighted ? g.cin : min(n0 + kTileN, g.cin);
  for (int k0 = k_begin; k0 < k_end; k0 += kSimtChunk) {
    for (int i = tid; i < kHaloRows * kHaloCols; i += kThreads) {
      const int hr = i / kHaloCols;
      const int hc = i % kHaloCols;
      const int gr = reflect(r0 - 1 + hr, g.height);
      const int gc = reflect(c0 - 1 + hc, g.width);
      float v[8];
      load8(xb + ((size_t)gr * g.width + gc) * g.cin + k0, v);
#pragma unroll
      for (int k = 0; k < kSimtChunk; ++k) halo[hr][k][hc] = v[k];
    }
    if constexpr (kWeighted) {
      constexpr int kGroups = kTileN / 8;
      for (int i = tid; i < 9 * kSimtChunk * kGroups; i += kThreads) {
        const int tap = i / (kSimtChunk * kGroups);
        const int k = (i / kGroups) % kSimtChunk;
        const int j = (i % kGroups) * 8;
        float v[8] = {};
        if (n0 + j < g.cout) load8(w + ((size_t)tap * g.cin + k0 + k) * g.cout + n0 + j, v);
#pragma unroll
        for (int q = 0; q < 8; ++q) wt[tap][k][j + q] = v[q];
      }
    }
    __syncthreads();

    if constexpr (MODE == kFull) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll 2
        for (int k = 0; k < kSimtChunk; ++k) {
          float a[10];
#pragma unroll
          for (int i = 0; i < 10; ++i) a[i] = halo[prow + dy][k][pcol + i];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4 b = *reinterpret_cast<const float4*>(&wt[dy * 3 + dx][k][4 * tn]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][0] = fmaf(a[i + dx], b.x, acc[i][0]);
              acc[i][1] = fmaf(a[i + dx], b.y, acc[i][1]);
              acc[i][2] = fmaf(a[i + dx], b.z, acc[i][2]);
              acc[i][3] = fmaf(a[i + dx], b.w, acc[i][3]);
            }
          }
        }
      }
    } else if constexpr (MODE == kMxuOnly) {
#pragma unroll 2
      for (int k = 0; k < kSimtChunk; ++k) {
        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = halo[prow][k][pcol + i];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const float4 b = *reinterpret_cast<const float4*>(&wt[tap][k][4 * tn]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
            acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
            acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
            acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
          }
        }
      }
    } else if (n >= k0 && n < k0 + kSimtChunk) {  // this thread's 4 channels are staged
      const int kk = n - k0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if constexpr (MODE == kDmaOnly) {
            acc[i][j] = halo[prow][kk + j][pcol + i];
          } else {  // the 9 shifted taps, summed in the plain version's order
            float s = 0.f;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) s = __fadd_rn(s, halo[prow + dy][kk + j][pcol + i + dx]);
            }
            acc[i][j] = s;
          }
        }
      }
    }
    __syncthreads();
  }

  const int r = r0 + prow;
  if (r >= g.height || n >= g.cout) return;
  T* yrow = y + (((size_t)blockIdx.z * g.height + r) * g.width) * g.cout + n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + pcol + i;
    if (c < g.width) store4(yrow + (size_t)c * g.cout, acc[i]);
  }
}

// bf16 modes 0 and 1 on the tensor cores. 8 warps: warp w owns tile row
// w / 2, all 32 columns (two 16-pixel A tiles) and channels 32 * (w % 2)
// .. + 31 (two 16-channel B tiles).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
pad_conv3x3_wmma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ y, Geometry g) {
  using namespace nvcuda;
  constexpr int kHaloBytes = kHaloRows * kHaloCols * kMmaChunk * 2;  // 6528, a multiple of 32
  constexpr int kWeightBytes = 9 * kMmaChunk * kTileN * 2;
  constexpr int kStageBytes = kTileRows * kTileCols * kTileN * 4;
  constexpr int kSmemBytes = kHaloBytes + kWeightBytes > kStageBytes
                                 ? kHaloBytes + kWeightBytes : kStageBytes;
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);  // [row][col][16 channels]
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + kHaloBytes);  // [tap][k][n]
  float* stage = reinterpret_cast<float*>(smem);  // the epilogue's [pixel][n], after the loop

  const int r0 = (blockIdx.x / g.col_tiles) * kTileRows;
  const int c0 = (blockIdx.x % g.col_tiles) * kTileCols;
  const int n0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wrow = warp / 2;
  const int wn = (warp % 2) * 32;
  const __nv_bfloat16* xb = x + (size_t)blockIdx.z * g.height * g.width * g.cin;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < g.cin; k0 += kMmaChunk) {
    // halo: two 8-channel vectors a pixel; channels past C_in are zero
    for (int i = tid; i < kHaloRows * kHaloCols * 2; i += kThreads) {
      const int pix = i / 2;
      const int k = k0 + (i % 2) * 8;
      const int gr = reflect(r0 - 1 + pix / kHaloCols, g.height);
      const int gc = reflect(c0 - 1 + pix % kHaloCols, g.width);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < g.cin) v = *reinterpret_cast<const uint4*>(xb + ((size_t)gr * g.width + gc) * g.cin + k);
      *reinterpret_cast<uint4*>(halo + pix * kMmaChunk + (i % 2) * 8) = v;
    }
    constexpr int kGroups = kTileN / 8;
    for (int i = tid; i < 9 * kMmaChunk * kGroups; i += kThreads) {
      const int tap = i / (kMmaChunk * kGroups);
      const int k = (i / kGroups) % kMmaChunk;
      const int j = (i % kGroups) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k0 + k < g.cin && n0 + j < g.cout) {
        v = *reinterpret_cast<const uint4*>(w + ((size_t)tap * g.cin + k0 + k) * g.cout + n0 + j);
      }
      *reinterpret_cast<uint4*>(wt + (tap * kMmaChunk + k) * kTileN + j) = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = MODE == kFull ? tap / 3 : 0;
      const int dx = MODE == kFull ? tap % 3 : 0;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], halo + ((wrow + dy) * kHaloCols + 16 * i + dx) * kMmaChunk,
                               kMmaChunk);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(b[j], wt + tap * kMmaChunk * kTileN + wn + 16 * j, kTileN);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage + (wrow * kTileCols + 16 * i) * kTileN + wn + 16 * j,
                              acc[i][j], kTileN, wmma::mem_row_major);
    }
  __syncthreads();

  constexpr int kGroups = kTileN / 8;
  for (int i = tid; i < kTileRows * kTileCols * kGroups; i += kThreads) {
    const int p = i / kGroups;
    const int j = (i % kGroups) * 8;
    const int r = r0 + p / kTileCols;
    const int c = c0 + p % kTileCols;
    if (r >= g.height || c >= g.width || n0 + j >= g.cout) continue;
    const float* s = stage + p * kTileN + j;
    *reinterpret_cast<uint4*>(y + (((size_t)blockIdx.z * g.height + r) * g.width + c) * g.cout +
                              n0 + j) =
        make_uint4(pack_bf16x2(s[0], s[1]), pack_bf16x2(s[2], s[3]), pack_bf16x2(s[4], s[5]),
                   pack_bf16x2(s[6], s[7]));
  }
}

}  // namespace

// x (batch, height, width, cin), w (3, 3, cin, cout), y (batch, height,
// width, cout), contiguous, 16-byte aligned, all f32 (bf16 == 0) or all
// bf16 (bf16 == 1). Modes 2 and 3 read no w and need cout == cin. Needs
// height, width >= 2 and cin, cout multiples of 8. Launches on `stream`;
// returns the launch's cudaError_t (0 on success).
extern "C" int pad_conv3x3_launch(const void* x, const void* w, void* y, int batch, int height,
                                  int width, int cin, int cout, int mode, int bf16,
                                  void* stream) {
  if (batch < 1 || batch > 65535 || height < 2 || width < 2 || cin < 8 || cin % 8 != 0 ||
      cout < 8 || cout % 8 != 0 || mode < kFull || mode > kDmaOnly ||
      (bf16 != 0 && bf16 != 1) || ((mode == kShiftOnly || mode == kDmaOnly) && cout != cin)) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry g{height, width, cin, cout, (width + kTileCols - 1) / kTileCols};
  const int row_tiles = (height + kTileRows - 1) / kTileRows;
  const dim3 grid(g.col_tiles * row_tiles, (cout + kTileN - 1) / kTileN, batch);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  const __nv_bfloat16* xh = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* yh = static_cast<__nv_bfloat16*>(y);
  switch (4 * bf16 + mode) {
    case kFull:
      pad_conv3x3_simt<float, kFull><<<grid, kThreads, 0, s>>>(xf, wf, yf, g);
      break;
    case kMxuOnly:
      pad_conv3x3_simt<float, kMxuOnly><<<grid, kThreads, 0, s>>>(xf, wf, yf, g);
      break;
    case kShiftOnly:
      pad_conv3x3_simt<float, kShiftOnly><<<grid, kThreads, 0, s>>>(xf, wf, yf, g);
      break;
    case kDmaOnly:
      pad_conv3x3_simt<float, kDmaOnly><<<grid, kThreads, 0, s>>>(xf, wf, yf, g);
      break;
    case 4 + kFull:
      pad_conv3x3_wmma<kFull><<<grid, kThreads, 0, s>>>(xh, wh, yh, g);
      break;
    case 4 + kMxuOnly:
      pad_conv3x3_wmma<kMxuOnly><<<grid, kThreads, 0, s>>>(xh, wh, yh, g);
      break;
    case 4 + kShiftOnly:
      pad_conv3x3_simt<__nv_bfloat16, kShiftOnly><<<grid, kThreads, 0, s>>>(xh, wh, yh, g);
      break;
    default:
      pad_conv3x3_simt<__nv_bfloat16, kDmaOnly><<<grid, kThreads, 0, s>>>(xh, wh, yh, g);
      break;
  }
  return (int)cudaGetLastError();
}
