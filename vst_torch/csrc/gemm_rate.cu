// In-kernel matrix-product rate probe for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/bisect_mxu.py:make (pallas_call :28):
// y = sum_{rep < reps} x @ w with the reps loop inside the kernel and one
// f32 accumulator, y cast to x's dtype once. x (M, K), w (K, N), y (M, N),
// row-major, all f32 or all bf16.
//
// Design: a tiled GEMM whose K loop runs `reps` times. As in the script's
// fori_loop (acc + x @ w per rep), each rep's product is summed in its own
// registers and then added to the accumulator, so float32 rounding stays
// that of one K-long sum plus `reps` adds. A CTA owns a 64 x 64 tile of y
// and stages x and w tiles in shared memory, re-reading them from L2 on
// every rep: at K = 1152 one 64-row f32 x tile is 295 KB, more than shared
// memory holds, so the TPU probe's VMEM-resident operands have no
// counterpart here.
//   bf16: tensor cores through wmma 16x16x16 bf16 -> f32; 4 warps, each
//     32 x 32 of the tile (2 x 2 fragments), K staged 32 at a time.
//   f32 (TF32 off): SIMT FMA; 256 threads, each 4 x 4 of the tile, K staged
//     16 at a time, x transposed in shared memory so both operands are read
//     as float4.
//
// Bound: operations. At M = 4096, K = N = 128, reps = 64: 8.59 GFLOP against
// 2.2 MB (f32) moved, 0.128 ms at 67 TFLOP/s SIMT f32 and 0.0087 ms at
// 989 TFLOP/s bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;

constexpr int kSimtBK = 16;
constexpr int kSimtThreads = 256;

__global__ void __launch_bounds__(kSimtThreads)
gemm_rate_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
              int M, int N, int K, int reps) {
  __shared__ __align__(16) float xs[kSimtBK][kBM];  // [k][m]
  __shared__ __align__(16) float ws[kSimtBK][kBN];  // [k][n]
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns n0 + 4 tx .. + 3
  const int ty = tid / 16;  // rows m0 + 4 ty .. + 3
  float acc[4][4] = {};

  for (int rep = 0; rep < reps; ++rep) {
    float part[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += kSimtBK) {
      {  // x: row tid / 4, k (tid % 4) * 4 .. + 3
        const int r = tid / 4;
        const int kk = (tid % 4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m0 + r < M && k0 + kk < K) {
          v = *reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * K + k0 + kk);
        }
        xs[kk][r] = v.x;
        xs[kk + 1][r] = v.y;
        xs[kk + 2][r] = v.z;
        xs[kk + 3][r] = v.w;
      }
      {  // w: k tid / 16, columns (tid % 16) * 4 .. + 3
        const int kk = tid / 16;
        const int c = (tid % 16) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + kk < K && n0 + c < N) {
          v = *reinterpret_cast<const float4*>(w + (size_t)(k0 + kk) * N + n0 + c);
        }
        *reinterpret_cast<float4*>(&ws[kk][c]) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSimtBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }

  const int c = n0 + 4 * tx;
  if (c >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * ty + i;
    if (r < M) {
      *reinterpret_cast<float4*>(y + (size_t)r * N + c) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

constexpr int kMmaBK = 32;
constexpr int kMmaThreads = 128;
constexpr int kXsLd = kMmaBK + 8;  // padded rows; multiples of 8 elements, as wmma needs
constexpr int kWsLd = kBN + 8;

// two floats rounded to bf16, the first in the low half (the lower address)
__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__global__ void __launch_bounds__(kMmaThreads)
gemm_rate_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ y, int M, int N, int K, int reps) {
  using namespace nvcuda;
  constexpr int kXsBytes = kBM * kXsLd * 2;  // 5120, a multiple of 32
  constexpr int kWsBytes = kMmaBK * kWsLd * 2;
  constexpr int kStageBytes = kBM * kBN * 4;
  constexpr int kSmemBytes = kXsBytes + kWsBytes > kStageBytes ? kXsBytes + kWsBytes : kStageBytes;
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);              // [m][k]
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + kXsBytes);   // [k][n]
  float* stage = reinterpret_cast<float*>(smem);  // the epilogue's [m][n], after the loop

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2], part[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[i][j], 0.f);
    for (int k0 = 0; k0 < K; k0 += kMmaBK) {
      for (int i = tid; i < kBM * kMmaBK / 8; i += kMmaThreads) {
        const int r = i / (kMmaBK / 8);
        const int kk = (i % (kMmaBK / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (m0 + r < M && k0 + kk < K) {
          v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + kk);
        }
        *reinterpret_cast<uint4*>(xs + r * kXsLd + kk) = v;
      }
      for (int i = tid; i < kMmaBK * kBN / 8; i += kMmaThreads) {
        const int kk = i / (kBN / 8);
        const int c = (i % (kBN / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k0 + kk < K && n0 + c < N) {
          v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kk) * N + n0 + c);
        }
        *reinterpret_cast<uint4*>(ws + kk * kWsLd + c) = v;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kMmaBK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], xs + (wm + 16 * i) * kXsLd + ks, kXsLd);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], ws + ks * kWsLd + wn + 16 * j, kWsLd);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(part[i][j], a[i], b[j], part[i][j]);
      }
      __syncthreads();
    }
    // part and acc are fragments of one type, so their elements pair up
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < acc[i][j].num_elements; ++t) acc[i][j].x[t] += part[i][j].x[t];
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage + (wm + 16 * i) * kBN + wn + 16 * j, acc[i][j], kBN,
                              wmma::mem_row_major);
    }
  __syncthreads();
  for (int i = tid; i < kBM * kBN / 8; i += kMmaThreads) {
    const int r = i / (kBN / 8);
    const int c = (i % (kBN / 8)) * 8;
    if (m0 + r >= M || n0 + c >= N) continue;
    const float* s = stage + r * kBN + c;
    *reinterpret_cast<uint4*>(y + (size_t)(m0 + r) * N + n0 + c) =
        make_uint4(pack_bf16x2(s[0], s[1]), pack_bf16x2(s[2], s[3]), pack_bf16x2(s[4], s[5]),
                   pack_bf16x2(s[6], s[7]));
  }
}

}  // namespace

// x (M, K), w (K, N), y (M, N), row-major, contiguous, 16-byte aligned, all
// f32 (bf16 == 0) or all bf16 (bf16 == 1); K and N multiples of 8. Launches
// on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int gemm_rate_launch(const void* x, const void* w, void* y, int M, int N, int K,
                                int reps, int bf16, void* stream) {
  if (M < 1 || N < 8 || K < 8 || N % 8 != 0 || K % 8 != 0 || reps < 0 || (bf16 != 0 && bf16 != 1) ||
      (M + kBM - 1) / kBM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    gemm_rate_bf16<<<grid, kMmaThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                static_cast<const __nv_bfloat16*>(w),
                                                static_cast<__nv_bfloat16*>(y), M, N, K, reps);
  } else {
    gemm_rate_f32<<<grid, kSimtThreads, 0, s>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w),
                                               static_cast<float*>(y), M, N, K, reps);
  }
  return (int)cudaGetLastError();
}
