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
// Design: an implicit GEMM, M = pixels, K = 9*C_in, N = C_out. A CTA owns a
// tile of output rows x 32 output columns and stages, for each chunk of
// input channels, the tile's input halo (2 rows and 2 columns more) in shared
// memory, resolving the reflection in the load's source address (row -1 ->
// 1, row H -> H-2, the same for columns): no padded copy is written to device
// memory, the counterpart of the TPU kernel's reflected-row DMAs and column
// concat. Rows and columns past the ragged edge (H = 109) are computed from
// clamped indices and masked at the store.
//   f32, modes 0 and 1 (TF32 off, SIMT FMA, f32 sums). Bound: operations,
//     2 * 27904 * 9 * 128^2 = 8.23 GFLOP a conv at the trunk shape, 0.123 ms
//     at the 67 TFLOP/s f32 rate. The first version of this kernel ran at
//     49 % of that rate (0.250 ms): each 8-channel chunk staged by
//     synchronous loads between two barriers, 32 accumulators a thread (10
//     scalar halo loads and 3 float4 weight loads per 96 FMAs), the halo
//     staged twice (64 of the 128 output channels a CTA), 448 CTAs of 256
//     threads on 132 SMs. Now:
//     - a CTA owns 7 rows x 32 columns x all 128 output channels (C_out >
//       128 in further CTAs), so the halo is staged once, and the trunk
//       shape is 16 x 8 = 128 CTAs: one wave, one CTA (200 KB of shared
//       memory, 512 threads) on each of 128 of the 132 SMs;
//     - 16 warps, 4 on each scheduler; a thread owns 2 columns x 7 rows x 4
//       channels, 56 accumulators. The halo is stored column-major, a
//       column's 9 rows padded to 12 floats (3 bank groups apart, so the 4
//       column pairs of a warp's load fall in 4 bank groups): for each
//       (k, dx) a thread reads its 2 shifted columns with 2 float4 and 1
//       scalar load each and uses them for the 3 dy taps, whose 4 weights
//       are one float4 that 8 lanes share as 128 contiguous bytes; 504 FMAs
//       per 27 shared loads (mxu_only: 504 per 13);
//     - chunks of 16 input channels through a ring of 2 stages (8 and 3
//       where C_in is not a multiple of 16), one barrier a chunk: the copies
//       of chunk c+1 run under the products of chunk c. Warp 0 has the TMA
//       unit bring the weights (one bulk copy a tap where C_out is 128, else
//       one a row; an mbarrier counts the bytes), which in design trials
//       beat 16-byte cp.async from every thread; every thread copies its
//       share of the halo with 4-byte cp.async (a channel-major column
//       cannot take a pixel's 16 channel-contiguous bytes), each source
//       address already reflected and clamped.
//     On the H100 (700 W): 0.187 ms (full), 0.171 ms (mxu_only); the
//     products alone, staging only the first chunk, take 0.172 ms (76 % of
//     the FMA rate on 128 SMs), so the staging costs about 8 % and the loop
//     the rest (python -m vst_torch.probes.kernel_trials). ptxas: 127-128
//     registers (512 threads cap them at 128), no spill.
//   bf16, modes 0 and 1: warpgroup wgmma m64n128k16, A from registers, B
//     from shared memory. A CTA owns all output channels of its 4 x 32 = 128
//     pixels (C_out > 128 in further CTAs of 128), so each halo chunk is
//     staged once: 2 consumer warpgroups of 64 pixels, 224 CTAs at the trunk
//     shape, 2 resident on an SM (87 KB of shared memory each), so all 224
//     run in one wave on 132 SMs. Per 16 input channels a stage holds the
//     halo, channel-contiguous (32 bytes a pixel, the two 16-byte halves
//     swapped on every other group of 4 pixels so that ldmatrix's 8 rows
//     hit 8 bank groups), and the 9 taps' 16 x 128 weights in the
//     128-byte-swizzled N-major layout wgmma reads. Each tap's A fragment
//     is one ldmatrix.x4 from the halo at its (dy, dx) offset (any 16-byte
//     row address, so a shift costs nothing; mxu_only loads the unshifted
//     tile once for all 9 taps). Stages are filled by 16-byte cp.async
//     whose source address resolves the reflection and the ragged-edge
//     clamp, with channels past C_in and C_out zero-filled, in a ring of 2:
//     one barrier per chunk, and the copies of chunk c+1 run under the
//     products of chunk c. Bound: 0.0083 ms at the 989 TFLOP/s bf16 rate.
//   modes 2 and 3, both dtypes: no product, so the bound is bytes: x read
//     once and y written once, 0.0085 ms (f32) / 0.0043 ms (bf16) at the
//     trunk shape at 3.35 TB/s. Both work on 16-byte channel-contiguous
//     vectors (4 f32 or 8 bf16 channels), so neither converts on the way in
//     and every lane of a warp moves 16 bytes of one 512-byte run.
//     - dma_only is a gather copy: output row r is input row reflect(r - 1)
//       moved one pixel right, with column 0 taken from column 1. No shared
//       memory and no barrier: a thread loads kCopyVecs vectors of one row,
//       all in flight, then stores them; a CTA covers 16 KB of a row, so the
//       trunk shape is 872 (f32) / 436 (bf16) CTAs, one wave on 132 SMs.
//     - shift_only: a CTA owns kShiftRows output rows x 32 columns x one
//       128-byte slice of the channels (8 vectors), and brings its halo,
//       (kShiftRows + 2) rows x 34 columns of slices, into shared memory by
//       16-byte cp.async, every copy in flight at once, the reflection and
//       the ragged-edge clamp resolved in the source address. A thread then
//       owns one vector of one column and walks the kShiftRows rows with the
//       3 x 3 window in registers, reading one new halo row (3 vectors) per
//       row: each halo vector is read from device memory once a CTA (the
//       halo re-reads (10 x 34) / (8 x 32) = 1.33x of x, mostly from L2),
//       and the sum is taken in f32 in the plain version's (dy, dx) order,
//       so it is bit for bit the plain version's. Chosen over a register
//       window that loads its side columns itself (15 % slower), and over
//       4 and 16 rows, by the split of python -m
//       vst_torch.probes.kernel_trials.
//     On the H100 (700 W), the kernel alone on inputs cold in L2: dma_only
//     0.0112 ms (f32, 76 % of the bound) / 0.0067 (bf16, 64 %), shift_only
//     0.0123 (69 %) / 0.0077 (56 %); shift_only's staging alone 0.0081 /
//     0.0051, its stores alone 0.0064 / 0.0039.
// ptxas registers and spills: printed by chip_smoke.py's build phase (bf16
// full 128 registers with 20 bytes of spill, mxu_only 120; shift_only 40
// (f32) / 72 (bf16), dma_only 32, no spill).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

enum Mode { kFull = 0, kMxuOnly = 1, kShiftOnly = 2, kDmaOnly = 3 };

constexpr int kTileRows = 4;
constexpr int kTileCols = 32;
constexpr int kHaloRows = kTileRows + 2;
constexpr int kHaloCols = kTileCols + 2;

constexpr int kHaloThreads = 256;  // modes 2 and 3
constexpr int kCopyVecs = 4;       // dma_only: 16-byte vectors a thread
constexpr int kSliceVecs = 8;      // shift_only: 16-byte vectors of a pixel a CTA (128 bytes)
constexpr int kShiftRows = 8;      // shift_only: output rows a CTA
constexpr int kShiftCols = kHaloThreads / kSliceVecs;  // 32 output columns a CTA
constexpr int kShiftSmem = (kShiftRows + 2) * (kShiftCols + 2) * kSliceVecs * 16;

constexpr int kF32Rows = 7;        // output rows a CTA, f32 modes 0 and 1
constexpr int kF32N = 128;         // output channels a CTA
constexpr int kF32Threads = 512;   // 16 warps, 4 on each scheduler
constexpr int kF32ThreadCols = 2;  // output columns a thread
constexpr int kF32HaloRows = kF32Rows + 2;
constexpr int kF32HaloCols = kTileCols + 2;
constexpr int kF32ColStride = 12;  // floats a halo column: 9 rows and 3 of skew

constexpr int kMmaN = 128;       // output channels per CTA, wgmma path
constexpr int kMmaThreads = 256; // two warpgroups
constexpr int kMmaChunk = 16;    // input channels per stage (one wgmma K step)
constexpr int kMmaStages = 2;
constexpr int kHaloPixels = kHaloRows * kHaloCols;
constexpr int kWeightBytes = 9 * 2 * kMmaChunk * 128;  // [tap][64-channel atom][k][128 B]
constexpr int kStageBytes = (kWeightBytes + kHaloPixels * 32 + 1023) / 1024 * 1024;
constexpr int kMmaSmem = kMmaStages * kStageBytes + 1024;  // + alignment to 1024

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

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// s += the 16-byte vector v, as 4 f32 or 8 bf16 values (a bf16 is the top
// half of its f32, so the widening is exact)
__device__ __forceinline__ void accumulate(float (&s)[4], const uint4& v) {
  s[0] = __fadd_rn(s[0], __uint_as_float(v.x));
  s[1] = __fadd_rn(s[1], __uint_as_float(v.y));
  s[2] = __fadd_rn(s[2], __uint_as_float(v.z));
  s[3] = __fadd_rn(s[3], __uint_as_float(v.w));
}

__device__ __forceinline__ void accumulate(float (&s)[8], const uint4& v) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[2 * i] = __fadd_rn(s[2 * i], __uint_as_float(u[i] << 16));
    s[2 * i + 1] = __fadd_rn(s[2 * i + 1], __uint_as_float(u[i] & 0xffff0000u));
  }
}

__device__ __forceinline__ uint4 pack(const float (&s)[4]) {
  return make_uint4(__float_as_uint(s[0]), __float_as_uint(s[1]), __float_as_uint(s[2]),
                    __float_as_uint(s[3]));
}

__device__ __forceinline__ uint4 pack(const float (&s)[8]) {  // rounded to nearest even
  return make_uint4(vst::pack_bf16x2(s[0], s[1]), vst::pack_bf16x2(s[2], s[3]),
                    vst::pack_bf16x2(s[4], s[5]), vst::pack_bf16x2(s[6], s[7]));
}

// dma_only, both dtypes, as 16-byte vectors (vpp a pixel, row_vecs a row):
// y[n, r, c] = x[n, reflect(r - 1), reflect(c - 1)]. CTA b copies vectors
// chunk * 1024 .. + 1023 of output row b / chunks (of all batch * height).
__global__ void __launch_bounds__(kHaloThreads)
pad_shift_copy(const uint4* __restrict__ x, uint4* __restrict__ y, int height, int row_vecs,
               int vpp, int chunks) {
  const int row = blockIdx.x / chunks;  // n * height + r
  const int first = (blockIdx.x % chunks) * kHaloThreads * kCopyVecs + threadIdx.x;
  const uint4* src = x + (size_t)(row % height == 0 ? row + 1 : row - 1) * row_vecs;
  uint4* dst = y + (size_t)row * row_vecs;
  uint4 v[kCopyVecs];
#pragma unroll
  for (int j = 0; j < kCopyVecs; ++j) {
    const int i = first + j * kHaloThreads;  // column 0 from column 1, column c from c - 1
    if (i < row_vecs) v[j] = __ldg(src + (i < vpp ? i + vpp : i - vpp));
  }
#pragma unroll
  for (int j = 0; j < kCopyVecs; ++j) {
    const int i = first + j * kHaloThreads;
    if (i < row_vecs) dst[i] = v[j];
  }
}

// shift_only, both dtypes (LANES: 4 f32 or 8 bf16 values a vector). A CTA owns
// kShiftRows output rows x 32 columns x vectors k0 .. k0 + 7 of each pixel;
// thread t owns vector k0 + t % 8 of column t / 8.
template <int LANES>
__global__ void __launch_bounds__(kHaloThreads)
pad_shift_sum(const uint4* __restrict__ x, uint4* __restrict__ y, Geometry g, int vpp) {
  extern __shared__ uint4 halo_tile[];  // [kShiftRows + 2][kShiftCols + 2][kSliceVecs]
  constexpr int kCols = kShiftCols + 2;
  const int r0 = (blockIdx.x / g.col_tiles) * kShiftRows;
  const int c0 = (blockIdx.x % g.col_tiles) * kShiftCols;
  const int k0 = blockIdx.y * kSliceVecs;
  const int nvec = min(kSliceVecs, vpp - k0);
  const size_t image = (size_t)blockIdx.z * g.height * g.width;
  const uint4* xb = x + image * vpp + k0;
  for (int i = threadIdx.x; i < (kShiftRows + 2) * kCols * kSliceVecs; i += kHaloThreads) {
    const int k = i % kSliceVecs, pix = i / kSliceVecs;
    if (k < nvec) {
      const int gr = reflect(r0 - 1 + pix / kCols, g.height);
      const int gc = reflect(c0 - 1 + pix % kCols, g.width);
      vst::cp_async16(vst::smem_addr(halo_tile + i), xb + ((size_t)gr * g.width + gc) * vpp + k, 16);
    }
  }
  vst::cp_async_commit();
  vst::cp_async_wait<0>();
  __syncthreads();

  const int k = threadIdx.x % kSliceVecs, col = threadIdx.x / kSliceVecs;
  const int c = c0 + col;
  if (k >= nvec || c >= g.width) return;
  const uint4* t = halo_tile + col * kSliceVecs + k;  // halo row 0, the window's left column
  uint4 win[3][3];  // halo rows i, i + 1, i + 2 at slots i % 3, ..., columns c - 1, c, c + 1
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) win[hr][dx] = t[(hr * kCols + dx) * kSliceVecs];
#pragma unroll
  for (int i = 0; i < kShiftRows; ++i) {
    if (r0 + i >= g.height) break;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) win[(i + 2) % 3][dx] = t[((i + 2) * kCols + dx) * kSliceVecs];
    float s[LANES] = {};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) accumulate(s, win[(i + dy) % 3][dx]);
    y[(image + (size_t)(r0 + i) * g.width + c) * vpp + k0 + k] = pack(s);
  }
}

// vpp: 16-byte vectors a pixel. The copy indexes a row's vectors and its
// CTAs in 32 bits, and refuses a shape past that.
int launch_copy(const uint4* x, uint4* y, const Geometry& g, int vpp, int batch, cudaStream_t s) {
  const long long row_vecs = (long long)g.width * vpp;
  const long long chunks = (row_vecs + kHaloThreads * kCopyVecs - 1) / (kHaloThreads * kCopyVecs);
  const long long ctas = (long long)batch * g.height * chunks;
  if (row_vecs > (1 << 30) || ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  pad_shift_copy<<<(unsigned)ctas, kHaloThreads, 0, s>>>(x, y, g.height, (int)row_vecs, vpp,
                                                       (int)chunks);
  return (int)cudaGetLastError();
}

template <int LANES>
int launch_shift_sum(const uint4* x, uint4* y, const Geometry& g, int vpp, int batch,
                     cudaStream_t s) {
  static_assert(kShiftCols == kTileCols, "shift_only tiles columns as Geometry::col_tiles does");
  static bool smem_allowed = false;
  const cudaError_t err = vst::allow_smem(pad_shift_sum<LANES>, kShiftSmem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(g.col_tiles * ((g.height + kShiftRows - 1) / kShiftRows),
                  (vpp + kSliceVecs - 1) / kSliceVecs, batch);
  pad_shift_sum<LANES><<<grid, kHaloThreads, kShiftSmem, s>>>(x, y, g, vpp);
  return (int)cudaGetLastError();
}

// f32 modes 0 and 1: chunks of KC input channels through a ring of S stages.
// A stage: the 9 taps' weights [tap][k][128 channels], then the halo
// [k][34 columns][12]: a column's 9 rows, padded to 12 floats.
template <int KC, int S>
struct F32Ring {
  static constexpr int kChunk = KC, kStages = S;
  static constexpr int kWeightFloats = 9 * KC * kF32N;
  static constexpr int kStageFloats = kWeightFloats + KC * kF32HaloCols * kF32ColStride;
  static constexpr int kSmem = S * kStageFloats * 4;
};

// Stages chunk k0 .. k0 + KC - 1. Warp 0 has the TMA unit copy the weights,
// counted on `bar`: a tap's KC rows are one block where C_out is 128, else
// one copy a row of the CTA's `ncols` channels. Every thread copies its share
// of the halo, 4 bytes at a time, the source address reflected and clamped.
template <class Ring>
__device__ __forceinline__ void stage_f32(float* st, uint32_t bar, const float* __restrict__ xb,
                                          const float* __restrict__ w, const Geometry& g, int r0,
                                          int c0, int n0, int ncols, int k0) {
  constexpr int KC = Ring::kChunk;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) vst::mbar_expect_tx(bar, 9 * KC * ncols * 4);
    __syncwarp();
    if (g.cout == kF32N) {
      if (lane < 9) {
        vst::bulk_load(vst::smem_addr(st + lane * KC * kF32N),
                       w + ((size_t)lane * g.cin + k0) * kF32N, KC * kF32N * 4, bar);
      }
    } else {
      for (int row = lane; row < 9 * KC; row += 32) {  // row = tap * KC + k
        const int tap = row / KC, k = row % KC;
        vst::bulk_load(vst::smem_addr(st + row * kF32N),
                       w + ((size_t)tap * g.cin + k0 + k) * g.cout + n0, ncols * 4, bar);
      }
    }
  }
  float* halo = st + Ring::kWeightFloats;
  for (int i = threadIdx.x; i < kF32HaloRows * kF32HaloCols * KC; i += kF32Threads) {
    const int k = i % KC;  // a pixel's channels from neighbouring threads
    const int pix = i / KC;
    const int hr = pix / kF32HaloCols, hc = pix % kF32HaloCols;
    const int gr = reflect(r0 - 1 + hr, g.height);
    const int gc = reflect(c0 - 1 + hc, g.width);
    vst::cp_async4(vst::smem_addr(halo + (k * kF32HaloCols + hc) * kF32ColStride + hr),
                   xb + ((size_t)gr * g.width + gc) * g.cin + k0 + k, 4);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a halo column's first N rows (N <= 9)
template <int N>
__device__ __forceinline__ void load_column(const float* h, float (&a)[N]) {
  const float4 lo = ld4(h);
  const float4 hi = ld4(h + 4);
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int i = 0; i < (N < 8 ? N : 8); ++i) a[i] = v[i];
  if constexpr (N > 8) a[8] = h[8];
}

// Warp w, lane l: output columns 2 (4 (w % 4) + l / 8) and the next, all 7
// rows; channels 4 cg .. 4 cg + 3 with cg = 8 (w / 4) + l % 8, so a warp's
// float4 weight loads are 8 neighbouring 16-byte groups.
template <int MODE, class Ring>
__global__ void __launch_bounds__(kF32Threads, 1)
pad_conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                Geometry g) {
  constexpr int KC = Ring::kChunk, S = Ring::kStages, TC = kF32ThreadCols;
  extern __shared__ __align__(16) float f32_smem[];
  __shared__ __align__(8) uint64_t wbar[S];  // a stage's weights have landed
  const int r0 = (blockIdx.x / g.col_tiles) * kF32Rows;
  const int c0 = (blockIdx.x % g.col_tiles) * kTileCols;
  const int n0 = blockIdx.y * kF32N;
  const int ncols = min(kF32N, g.cout - n0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = TC * (4 * (warp % 4) + lane / 8);
  const int cg = 8 * (warp / 4) + lane % 8;
  const float* xb = x + (size_t)blockIdx.z * g.height * g.width * g.cin;
  const int chunks = g.cin / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) vst::mbar_init(vst::smem_addr(&wbar[s]), 1);
    vst::mbar_fence_init();
  }
  if (ncols < kF32N) {  // channels past C_out: zero the weight rows' tails, which no copy writes
    for (int i = threadIdx.x; i < S * Ring::kWeightFloats; i += kF32Threads) {
      if (i % kF32N >= ncols) {
        f32_smem[(i / Ring::kWeightFloats) * Ring::kStageFloats + i % Ring::kWeightFloats] = 0.f;
      }
    }
  }
  __syncthreads();

  float acc[TC * kF32Rows][4];
#pragma unroll
  for (int i = 0; i < TC * kF32Rows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < chunks) {
      stage_f32<Ring>(f32_smem + s * Ring::kStageFloats, vst::smem_addr(&wbar[s]), xb, w, g, r0,
                      c0, n0, ncols, s * KC);
    }
    vst::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    vst::cp_async_wait<S - 2>();                                // chunk c's halo has landed,
    vst::mbar_wait(vst::smem_addr(&wbar[c % S]), (c / S) & 1);  // and its weights,
    __syncthreads();                                            // and chunk c - 1's stage is free
    const int next = c + S - 1;
    if (next < chunks) {
      stage_f32<Ring>(f32_smem + (next % S) * Ring::kStageFloats,
                      vst::smem_addr(&wbar[next % S]), xb, w, g, r0, c0, n0, ncols, next * KC);
    }
    vst::cp_async_commit();

    const float* wt = f32_smem + (c % S) * Ring::kStageFloats + 4 * cg;
    const float* halo = f32_smem + (c % S) * Ring::kStageFloats + Ring::kWeightFloats +
                        col * kF32ColStride;
#pragma unroll 2
    for (int k = 0; k < KC; ++k) {
      // full: one pass per dx over the 2 columns it shifts to, each with its
      // 3 dy taps; mxu_only: one pass over the unshifted columns, all 9 taps
      constexpr int kPasses = MODE == kFull ? 3 : 1;
      constexpr int kTapsPerPass = 9 / kPasses;
      constexpr int kRows = MODE == kFull ? kF32HaloRows : kF32Rows;
#pragma unroll
      for (int dx = 0; dx < kPasses; ++dx) {
        float a[TC][kRows];
#pragma unroll
        for (int t = 0; t < TC; ++t)
          load_column(halo + (k * kF32HaloCols + t + dx) * kF32ColStride, a[t]);
#pragma unroll
        for (int p = 0; p < kTapsPerPass; ++p) {
          const int tap = MODE == kFull ? 3 * p + dx : p;
          const int dy = MODE == kFull ? p : 0;
          const float4 v = ld4(wt + (tap * KC + k) * kF32N);
          const float b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int t = 0; t < TC; ++t)
#pragma unroll
            for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[t * kF32Rows + i][j] = fmaf(a[t][i + dy], b[j], acc[t * kF32Rows + i][j]);
        }
      }
    }
  }
  vst::cp_async_wait<0>();

  if (n0 + 4 * cg >= g.cout) return;
#pragma unroll
  for (int t = 0; t < TC; ++t) {
    const int cc = c0 + col + t;
    if (cc >= g.width) break;
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      const int r = r0 + i;
      if (r >= g.height) break;
      store4(y + (((size_t)blockIdx.z * g.height + r) * g.width + cc) * g.cout + n0 + 4 * cg,
             acc[t * kF32Rows + i]);
    }
  }
}

template <int MODE, class Ring>
int launch_f32_ring(const float* x, const float* w, float* y, const Geometry& g, int batch,
                    cudaStream_t s) {
  static bool smem_allowed = false;
  const cudaError_t err = vst::allow_smem(pad_conv3x3_f32<MODE, Ring>, Ring::kSmem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(g.col_tiles * ((g.height + kF32Rows - 1) / kF32Rows),
                  (g.cout + kF32N - 1) / kF32N, batch);
  pad_conv3x3_f32<MODE, Ring><<<grid, kF32Threads, Ring::kSmem, s>>>(x, w, y, g);
  return (int)cudaGetLastError();
}

// chunks of 16 input channels in a ring of 2 where C_in allows, else of 8 in
// a ring of 3: a chunk never runs past C_in, so no copy needs a zero fill
template <int MODE>
int launch_f32(const float* x, const float* w, float* y, const Geometry& g, int batch,
               cudaStream_t s) {
  if (g.cin % 16 == 0) return launch_f32_ring<MODE, F32Ring<16, 2>>(x, w, y, g, batch, s);
  return launch_f32_ring<MODE, F32Ring<8, 3>>(x, w, y, g, batch, s);
}

// bf16 modes 0 and 1 on wgmma. Warpgroup wg owns tile pixels 64 wg .. + 63
// (tile rows 2 wg, 2 wg + 1); warp w of it holds 16 of them, one tile row,
// columns 16 (w % 2) .. + 15. d: the 64 x 128 f32 accumulator fragment.
__device__ __forceinline__ void stage_chunk(uint32_t stage, const __nv_bfloat16* __restrict__ xb,
                                            const __nv_bfloat16* __restrict__ w, const Geometry& g,
                                            int r0, int c0, int n0, int k0) {
  const uint32_t halo = stage + kWeightBytes;
  for (int i = threadIdx.x; i < kHaloPixels * 2; i += kMmaThreads) {
    const int pix = i / 2, h = i % 2;
    const int gr = reflect(r0 - 1 + pix / kHaloCols, g.height);
    const int gc = reflect(c0 - 1 + pix % kHaloCols, g.width);
    const int k = k0 + 8 * h;
    const bool ok = k < g.cin;
    const __nv_bfloat16* src = ok ? xb + ((size_t)gr * g.width + gc) * g.cin + k : xb;
    vst::cp_async16(halo + pix * 32 + ((h ^ ((pix >> 2) & 1)) << 4), src, ok ? 16 : 0);
  }
  // weights: tap, k, 16 groups of 8 output channels (two 64-channel atoms)
  for (int i = threadIdx.x; i < 9 * kMmaChunk * 16; i += kMmaThreads) {
    const int tap = i / (kMmaChunk * 16);
    const int k = (i / 16) % kMmaChunk;
    const int grp = i % 16;
    const bool ok = k0 + k < g.cin && n0 + 8 * grp < g.cout;
    const __nv_bfloat16* src = ok ? w + ((size_t)tap * g.cin + k0 + k) * g.cout + n0 + 8 * grp : w;
    vst::cp_async16(stage + tap * 4096 + (grp / 8) * 2048 + vst::swizzle128(k, grp % 8), src,
                    ok ? 16 : 0);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kMmaThreads, 2)
pad_conv3x3_wgmma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, Geometry g) {
  extern __shared__ unsigned char conv_smem[];
  const uint32_t base = (vst::smem_addr(conv_smem) + 1023) & ~1023u;
  const int r0 = (blockIdx.x / g.col_tiles) * kTileRows;
  const int c0 = (blockIdx.x % g.col_tiles) * kTileCols;
  const int n0 = blockIdx.y * kMmaN;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* xb = x + (size_t)blockIdx.z * g.height * g.width * g.cin;
  const int chunks = (g.cin + kMmaChunk - 1) / kMmaChunk;

  // this lane's ldmatrix row: pixel (lane % 8) + 8 ((lane / 8) % 2) of the
  // warp's 16, channel half lane / 16; as a halo pixel at tap (0, 0)
  const int tile_row = 2 * wg + warp / 2;
  const int lane_pix = tile_row * kHaloCols + 16 * (warp % 2) + lane % 8 + 8 * ((lane / 8) % 2);
  const int lane_half = lane / 16;

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  vst::fence_operands(d);

  stage_chunk(base, xb, w, g, r0, c0, n0, 0);
  vst::cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    vst::wgmma_wait<0>();       // chunk c-1's products are done with their stage
    vst::cp_async_wait<0>();    // chunk c has landed
    vst::fence_proxy_async();   // and is visible to wgmma
    __syncthreads();
    if (c + 1 < chunks) {
      stage_chunk(base + ((c + 1) % kMmaStages) * kStageBytes, xb, w, g, r0, c0, n0,
                  (c + 1) * kMmaChunk);
    }
    vst::cp_async_commit();

    const uint32_t stage = base + (c % kMmaStages) * kStageBytes;
    const uint32_t halo = stage + kWeightBytes;
    constexpr int kLoads = MODE == kFull ? 9 : 1;
    uint32_t a[kLoads][4];
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int hp = lane_pix + (t / 3) * kHaloCols + t % 3;
      vst::ldmatrix_x4(halo + hp * 32 + ((lane_half ^ ((hp >> 2) & 1)) << 4), a[t]);
    }
    vst::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const uint64_t b = vst::desc_sw128(stage + t * 4096, 2048, 1024);
      vst::wgmma_m64n128k16_rs(d, a[MODE == kFull ? t : 0], b);
    }
    vst::wgmma_commit();
  }
  vst::wgmma_wait<0>();
  vst::fence_operands(d);

  // d[4 j + 2 h + e]: tile pixel 64 wg + 16 warp + lane / 4 + 8 h, channel 8 j + 2 (lane % 4) + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = 64 * wg + 16 * warp + lane / 4 + 8 * h;
    const int r = r0 + p / kTileCols;
    const int col = c0 + p % kTileCols;
    if (r >= g.height || col >= g.width) continue;
    __nv_bfloat16* yp = y + (((size_t)blockIdx.z * g.height + r) * g.width + col) * g.cout;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n < g.cout)
        *reinterpret_cast<unsigned*>(yp + n) = vst::pack_bf16x2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
}

template <int MODE>
int launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y, const Geometry& g,
                 int row_tiles, int batch, cudaStream_t s) {
  static bool smem_allowed = false;
  const cudaError_t err = vst::allow_smem(pad_conv3x3_wgmma<MODE>, kMmaSmem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(g.col_tiles * row_tiles, (g.cout + kMmaN - 1) / kMmaN, batch);
  pad_conv3x3_wgmma<MODE><<<grid, kMmaThreads, kMmaSmem, s>>>(x, w, y, g);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  const __nv_bfloat16* xh = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* yh = static_cast<__nv_bfloat16*>(y);
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* yv = static_cast<uint4*>(y);
  const int vpp = cin / (bf16 ? 8 : 4);  // 16-byte vectors a pixel
  switch (4 * bf16 + mode) {
    case kFull:
      return launch_f32<kFull>(xf, wf, yf, g, batch, s);
    case kMxuOnly:
      return launch_f32<kMxuOnly>(xf, wf, yf, g, batch, s);
    case kShiftOnly:
      return launch_shift_sum<4>(xv, yv, g, vpp, batch, s);
    case 4 + kFull:
      return launch_wgmma<kFull>(xh, wh, yh, g, row_tiles, batch, s);
    case 4 + kMxuOnly:
      return launch_wgmma<kMxuOnly>(xh, wh, yh, g, row_tiles, batch, s);
    case 4 + kShiftOnly:
      return launch_shift_sum<8>(xv, yv, g, vpp, batch, s);
    default:  // dma_only: a byte copy, the same in both dtypes
      return launch_copy(xv, yv, g, vpp, batch, s);
  }
}
