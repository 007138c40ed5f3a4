// RAFT's SepConvGRU half-step (update.py:33-60) for Hopper (sm_90a), float32,
// as two fused implicit-GEMM kernels. With tap axis AXIS (0: 1x5, taps along
// the columns; 1: 5x1, taps along the rows), zero padding 2 along it:
//   gru_zr: z  = sigmoid(conv_z([h, x]) + b_z),
//           rh = sigmoid(conv_r([h, x]) + b_r) * h
//   gru_q:  h' = (1 - z) * h + z * tanh(conv_q([rh, x]) + b_q)
// h, z, rh, h' (B, 128, H, W) and x (B, C_x, H, W), NCHW; the weights packed
// by vst_torch/kernels/sepconv_gru.py:pack_gates as (5 taps, 128 + C_x, N)
// with N contiguous: z's 128 output channels then r's (N = 256), or q's (N =
// 128); biases (N). The concatenations [h, x] and [rh, x] are never written:
// a chunk of input channels is read from h (or rh) or from x.
//
// Replaces no TPU kernel: vst/flow/raft.py:206 (SepConvGRU) leaves the gates'
// convolutions and pointwise math to XLA. The port ran them as six
// convolutions a half-step on PyTorch's f32 path with cuDNN off (an im2col
// column buffer a sample, then one SGEMM), with two concatenations, two
// sigmoids, r * h, a tanh and the blend as launches of their own.
//
// Bound: operations. At batch 4 and 54x128 (RAFT's 1/8 grid at 432x1024),
// M = 27,648 pixels, K = 5 * 384: gru_zr 2 * M * K * 256 = 27.18 GFLOP,
// 0.4057 ms at the 67 TFLOP/s f32 rate; gru_q 13.59 GFLOP, 0.2028 ms.
//
// Design (TF32 off: SIMT FMA, f32 sums; expf and tanhf, not the fast
// intrinsics; the pointwise math rounded op by op in the plain code's order):
// - A CTA owns a tile of 8 rows x 16 columns (128 pixels) of one image and
//   all N output channels, so each staged input chunk feeds both gates of
//   gru_zr: 2N threads, 512 (one CTA an SM, 184 KB of shared memory) or 256
//   (two an SM, 104 KB each). At 54x128 that is 7 x 8 = 56 tiles an image:
//   224 CTAs at batch 4 (gru_zr two rounds of 132 SMs, gru_q one round of
//   264 slots), 112 at batch 2.
// - Warp w, lane l: channels 4 cg .. 4 cg + 3 with cg = 8 (w % (N / 32)) +
//   l % 8, so a quarter-warp's float4 weight loads are 128 contiguous bytes;
//   a block of 16 pixels shared by the quarter-warp (its halo loads
//   broadcast; a warp's 4 blocks read 4 bank groups): 8 columns x 2 rows for
//   1x5, 4 rows x 4 columns for 5x1. 64 accumulators. For each input channel
//   a thread loads its block's halo window (8 float4) and, for each of the 5
//   taps, one float4 of weights: 320 FMA per 13 shared loads.
// - Chunks of 16 input channels through a ring of 2 stages, one barrier a
//   chunk: the copies of chunk c + 1 run under the products of chunk c. One
//   thread has the TMA unit bring the weights (a bulk copy a tap), counted
//   in bytes on an mbarrier; every thread copies its share of the halo with
//   4-byte cp.async, zero-filling the taps outside the image, so any width
//   and any ragged edge take the one path. The halo is the tile and 2 pixels
//   more each side along the tap axis. In design trials on the H100 (batch
//   4, 54x128) a 5x1 block of 8 rows x 2 columns read as float2 was 16 %
//   slower than the 4 x 4 block; 8 channels a thread, or the k loop unrolled
//   by 2, changed nothing; a tap's products ordered channel by channel were
//   3 % faster than pixel by pixel.
// - Each output's 1920 products are summed in three parts of 640 (a third
//   of the chunks each): the first two go into the output tensor itself (P1,
//   then P1 + P2), the last stays in registers, and the epilogue adds (P1 +
//   P2) + P3 + bias. One running sum of 1920 products strayed 1.45 times as
//   far from the float64 sum as PyTorch's im2col SGEMM (7.9e-7 against
//   5.5e-7 at most, batch 4), enough to move MoGAN's small temporal losses
//   past the card tests' 1e-4; three parts stray 5.8e-7. They cost the 1x5
//   pass 5 % and the 5x1 pass 12 % (design trials).
// - The epilogue stages the sums through the free ring as a channel-major
//   tile, so that the bias, the nonlinearity and the reads of h (and z) and
//   the writes of z and rh (h') run along image rows. Ragged edges (H = 55,
//   W = 62, any width) are masked there.
// On the H100 (700 W), batch 4 at 54x128, the kernel alone on inputs cold in
// L2 (chip_smoke.py's sepconv_gru phase): gru_zr 0.792 / 0.871 ms (1x5 / 5x1)
// against its 0.406 ms bound, gru_q 0.408 / 0.436 against 0.203: the pair
// 50.7 % / 46.6 % of its bound; the plain half-step with cuDNN off 1.99 /
// 2.27 ms. What bounds it: gru_zr runs a CTA in 0.38-0.42 ms whether 92 or
// 132 SMs hold one, so 224 tiles take two rounds (85 % of the SMs' time);
// the products alone, staging only the first chunk, ran a round in 0.33 ms
// (75 % of the FMA rate an SM). A halo brought by the TMA unit (a 4-D tensor
// map, for widths that are a multiple of 4) ran the pair 5-6 % faster (1.131
// / 1.227 ms), about 1 % of a Sintel frame: not worth a second copy path.
// ptxas: 124-128 registers; one kernel spills 8 bytes, the others none.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kHidden = 128;  // channels of h, z, r, q
constexpr int kTaps = 5;
constexpr int kChunk = 16;  // input channels a stage
constexpr int kStages = 2;
constexpr int kTileRows = 8;
constexpr int kTileCols = 16;
constexpr int kTilePixels = kTileRows * kTileCols;
constexpr int kTileStride = kTilePixels + 1;  // floats a channel of the epilogue's tile

struct Geometry {
  int height, width, cx, col_tiles;
};

// A chunk's halo in shared memory, [k][row][col]: the tile and the taps' 2
// more pixels each side along the tap axis, rows r0 - 2 .. r0 + 9 for AXIS
// 1; for AXIS 0 columns c0 - 4 .. c0 + 19, 2 more each side than the taps
// need, so that a row's window is 4 float4 on 16 bytes and a warp's 4 blocks
// read 4 bank groups (columns c0 - 2 .. c0 + 17 in rows padded to 24 floats,
// 3 float4 a window, took gru_zr 1x5 from 0.785 to 0.898 ms in a design
// trial).
template <int AXIS>
struct Halo {
  static constexpr int kRows = kTileRows + (AXIS == 1 ? kTaps - 1 : 0);
  static constexpr int kCols = kTileCols + (AXIS == 0 ? 8 : 0);
  static constexpr int kFirstCol = AXIS == 0 ? -4 : 0;  // relative to c0
  static constexpr int kFloats = kChunk * kRows * kCols;
  static_assert(kCols % 4 == 0 && kFloats % 32 == 0, "16-byte rows");
};

// A thread's pixels: a block of kAlong pixels along the tap axis by kAcross
// lines across it (16 pixels, 4 output channels, 64 sums), its window
// kAlong + 4 halo values a line. AXIS 0: 8 columns x 2 rows, each row's
// window read as 4 float4 of the halo; AXIS 1: 4 rows x 4 columns, one
// float4 of 4 columns for each of the 8 window rows.
template <int AXIS>
struct Block {
  static constexpr int kAlong = AXIS == 0 ? 8 : 4;
  static constexpr int kAcross = 16 / kAlong;
  static constexpr int kWindow = kAlong + kTaps - 1;
  static constexpr int kBlocksAlong = (AXIS == 0 ? kTileCols : kTileRows) / kAlong;  // 2
  static constexpr int kBlocksAcross = (AXIS == 0 ? kTileRows : kTileCols) / kAcross;  // 4
  static_assert(kBlocksAlong * kBlocksAcross == 8, "8 blocks a tile");
};

// a stage: the 5 taps' weights [tap][k][N], then the halo
template <int AXIS, int N>
struct Ring {
  static constexpr int kThreads = 2 * N;
  static constexpr int kWeightFloats = kTaps * kChunk * N;
  static constexpr int kStageFloats = kWeightFloats + Halo<AXIS>::kFloats;
  static constexpr int kSmem = kStages * kStageFloats * 4 + 128;  // + alignment to 128
  static_assert(N * kTileStride <= kStages * kStageFloats, "the epilogue's tile fits the ring");
};

// Stages input channels k0 .. k0 + 15 of image b: one thread has the TMA
// unit copy the 5 taps' weights (one bulk copy each, counted in bytes on
// `bar`), and every thread copies its share of the halo with 4-byte
// cp.async, zero-filling taps outside the image.
template <int AXIS, int N>
__device__ __forceinline__ void stage(float* st, uint32_t bar, const float* __restrict__ a,
                                      const float* __restrict__ x,
                                      const float* __restrict__ w, const Geometry& g, int b,
                                      int r0, int c0, int k0) {
  using H = Halo<AXIS>;
  if (threadIdx.x == 0) {
    vst::mbar_expect_tx(bar, kTaps * kChunk * N * 4);
    for (int t = 0; t < kTaps; ++t) {
      vst::bulk_load(vst::smem_addr(st + t * kChunk * N),
                     w + ((size_t)t * (kHidden + g.cx) + k0) * N, kChunk * N * 4, bar);
    }
  }
  float* halo = st + Ring<AXIS, N>::kWeightFloats;
  const int hr0 = AXIS == 1 ? r0 - 2 : r0;  // the halo's first row and column
  const int hc0 = c0 + H::kFirstCol;
  const size_t plane = (size_t)g.height * g.width;
  const float* src = k0 < kHidden ? a + ((size_t)b * kHidden + k0) * plane
                                  : x + ((size_t)b * g.cx + k0 - kHidden) * plane;
  // one element an iteration, not unrolled: unrolled, the elements'
  // chunk-invariant offsets and masks are hoisted out of the chunk loop,
  // where their registers spill the sums
#pragma unroll 1
  for (int i = threadIdx.x; i < H::kFloats; i += Ring<AXIS, N>::kThreads) {
    const int col = i % H::kCols, line = i / H::kCols;  // line: k * kRows + row
    const int gr = hr0 + line % H::kRows, gc = hc0 + col;
    const bool inside = gr >= 0 && gr < g.height && gc >= 0 && gc < g.width;
    vst::cp_async4(vst::smem_addr(halo + i),
                   inside ? src + (size_t)(line / H::kRows) * plane + (size_t)gr * g.width + gc
                          : src,
                   inside ? 4 : 0);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The tile's sums over every input channel and tap (no bias) in three
// parts: the first two, over the first and second third of the chunks, added
// in `part` (P1 + P2); the last left in shared memory as [n][kTileStride],
// pixel (row, col) of the tile at row * 16 + col. Three sums of 640 products
// in place of one of 1920 round about 0.6 times as far from the exact sum.
// a: h (gru_zr) or rh (gru_q), the first 128 input channels; x the others.
// part(n): the output tensor a CTA writes channel n of into, at image b.
template <int AXIS, int N, class Part>
__device__ __forceinline__ void gate_sums(float* smem, uint64_t* bars, const float* __restrict__ a,
                                          const float* __restrict__ x,
                                          const float* __restrict__ w, const Geometry& g, int b,
                                          int r0, int c0, Part part) {
  using H = Halo<AXIS>;
  using R = Ring<AXIS, N>;
  using T = Block<AXIS>;
  constexpr int kChannelWarps = N / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cg = 8 * (warp % kChannelWarps) + lane % 8;     // channels 4 cg .. 4 cg + 3
  const int block = 4 * (warp / kChannelWarps) + lane / 8;  // shared by the quarter-warp
  // the block's first pixel along (ba kAlong) and across (bx kAcross); a
  // warp's 4 blocks are read from 4 bank groups
  const int ba = AXIS == 0 ? block % T::kBlocksAlong : block / T::kBlocksAcross;
  const int bx = AXIS == 0 ? block / T::kBlocksAlong : block % T::kBlocksAcross;
  const int chunks = (kHidden + g.cx) / kChunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) vst::mbar_init(vst::smem_addr(&bars[s]), 1);
    vst::mbar_fence_init();
  }
  __syncthreads();

  float acc[T::kAcross][T::kAlong][4];
#pragma unroll
  for (int q = 0; q < T::kAcross; ++q)
#pragma unroll
    for (int i = 0; i < T::kAlong; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.f;

  stage<AXIS, N>(smem, vst::smem_addr(&bars[0]), a, x, w, g, b, r0, c0, 0);
  vst::cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    vst::cp_async_wait<0>();                                   // chunk c has landed,
    vst::mbar_wait(vst::smem_addr(&bars[c % kStages]), (c / kStages) & 1);
    __syncthreads();                                           // and chunk c - 1's stage is free
    if (c + 1 < chunks) {
      stage<AXIS, N>(smem + ((c + 1) % kStages) * R::kStageFloats,
                     vst::smem_addr(&bars[(c + 1) % kStages]), a, x, w, g, b, r0, c0,
                     (c + 1) * kChunk);
    }
    vst::cp_async_commit();

    const float* st = smem + (c % kStages) * R::kStageFloats;
    const float* wt = st + 4 * cg;
    // AXIS 0: line q is tile row 2 bx + q; its window, halo columns 8 ba + 2
    // .. 8 ba + 13, read as the 4 float4 from 8 ba. AXIS 1: line q is tile
    // column 4 bx + q; its window, halo rows 4 ba .. 4 ba + 7, a float4 of
    // the 4 columns a row, each read just before its first tap.
    const float* hl = st + R::kWeightFloats +
                      (AXIS == 0 ? T::kAcross * bx * H::kCols + T::kAlong * ba
                                 : T::kAlong * ba * H::kCols + T::kAcross * bx);
#pragma unroll 1
    for (int k = 0; k < kChunk; ++k) {
      float in[T::kAcross][T::kWindow];
      if (AXIS == 0) {
#pragma unroll
        for (int q = 0; q < T::kAcross; ++q)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float4 f = ld4(hl + (k * H::kRows + q) * H::kCols + 4 * v);
            const float e[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int m = 4 * v + u - 2;
              if (m >= 0 && m < T::kWindow) in[q][m] = e[u];
            }
          }
      }
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        if (AXIS == 1) {
#pragma unroll
          for (int v = t == 0 ? 0 : t + T::kAlong - 1; v < t + T::kAlong; ++v) {
            const float4 f = ld4(hl + (k * H::kRows + v) * H::kCols);
            const float e[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int q = 0; q < T::kAcross; ++q) in[q][v] = e[q];
          }
        }
        const float4 f = ld4(wt + (t * kChunk + k) * N);
        const float wv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)  // 3 % faster than j innermost (design trials)
#pragma unroll
          for (int q = 0; q < T::kAcross; ++q)
#pragma unroll
            for (int i = 0; i < T::kAlong; ++i)
              acc[q][i][j] = fmaf(in[q][i + t], wv[j], acc[q][i][j]);
      }
    }

    if (c + 1 == chunks / 3 || c + 1 == 2 * chunks / 3) {  // a part is summed: P1, then P1 + P2
      const bool first = c + 1 == chunks / 3;
      // the addresses are worked out here from laundered values, not hoisted
      // out of the chunk loop, where their registers would spill the sums
      int row0 = r0 + (AXIS == 0 ? T::kAcross * bx : T::kAlong * ba);
      int col0 = c0 + (AXIS == 0 ? T::kAlong * ba : T::kAcross * bx);
      int n = 4 * cg, height = g.height;
      asm volatile("" : "+r"(row0), "+r"(col0), "+r"(n), "+r"(height));
      float* out = part(n);  // this thread's 4 channels lie in one output tensor
      const size_t plane = (size_t)height * g.width;
      // float4 rows where they sit on 16 bytes (a group of 4 columns is then in
      // or out); 5x1 stores scalars, 5 % faster for gru_q in design trials
      const bool vec = AXIS == 0 && g.width % 4 == 0;
      constexpr int kRows = AXIS == 0 ? T::kAcross : T::kAlong;
      constexpr int kGroups = (AXIS == 0 ? T::kAlong : T::kAcross) / 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int gc = 0; gc < kGroups; ++gc) {
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& s = AXIS == 0 ? acc[r][4 * gc + e][j] : acc[4 * gc + e][r][j];
              v[e] = s;
              s = 0.f;
            }
            const int row = row0 + r, col = col0 + 4 * gc;
            if (row >= g.height) continue;
            float* p = out + j * plane + (size_t)row * g.width + col;
            if (vec) {
              if (col >= g.width) continue;
              float4 o = make_float4(v[0], v[1], v[2], v[3]);
              if (!first) {
                const float4 f = ld4(p);
                o = make_float4(__fadd_rn(f.x, v[0]), __fadd_rn(f.y, v[1]), __fadd_rn(f.z, v[2]),
                                __fadd_rn(f.w, v[3]));
              }
              *reinterpret_cast<float4*>(p) = o;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (col + e < g.width) p[e] = first ? v[e] : __fadd_rn(p[e], v[e]);
            }
          }
    }
  }
  vst::cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring, and the parts are written

#pragma unroll
  for (int q = 0; q < T::kAcross; ++q)
#pragma unroll
    for (int i = 0; i < T::kAlong; ++i) {
      const int along = T::kAlong * ba + i, across = T::kAcross * bx + q;
      const int pix = AXIS == 0 ? across * kTileCols + along : along * kTileCols + across;
#pragma unroll
      for (int j = 0; j < 4; ++j) smem[(4 * cg + j) * kTileStride + pix] = acc[q][i][j];
    }
  __syncthreads();
}

__device__ __forceinline__ float* align128(float* p) {
  return reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(p) + 127) & ~uintptr_t(127));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <int AXIS>
__global__ void __launch_bounds__(512, 1)
gru_zr(const float* __restrict__ h, const float* __restrict__ x, const float* __restrict__ w,
       const float* __restrict__ bias, float* __restrict__ z, float* __restrict__ rh, Geometry g) {
  extern __shared__ float zr_smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages];
  constexpr int N = 2 * kHidden;
  float* smem = align128(zr_smem_raw);
  const int b = blockIdx.y;
  const int r0 = (blockIdx.x / g.col_tiles) * kTileRows;
  const int c0 = (blockIdx.x % g.col_tiles) * kTileCols;
  const size_t plane = (size_t)g.height * g.width;
  gate_sums<AXIS, N>(smem, bars, h, x, w, g, b, r0, c0, [&](int n) {
    return (n < kHidden ? z : rh) + ((size_t)b * kHidden + n % kHidden) * plane;
  });

  for (int i = threadIdx.x; i < N * kTilePixels; i += Ring<AXIS, N>::kThreads) {
    const int n = i / kTilePixels, p = i % kTilePixels;  // a warp's 32 pixels: one channel
    const int row = r0 + p / kTileCols, col = c0 + p % kTileCols;
    if (row >= g.height || col >= g.width) continue;
    const size_t o = ((size_t)b * kHidden + n % kHidden) * plane + (size_t)row * g.width + col;
    float* out = n < kHidden ? z : rh;
    const float s = sigmoid(__fadd_rn(__fadd_rn(out[o], smem[n * kTileStride + p]), bias[n]));
    out[o] = n < kHidden ? s : __fmul_rn(s, h[o]);
  }
}

template <int AXIS>
__global__ void __launch_bounds__(256, 2)
gru_q(const float* __restrict__ h, const float* __restrict__ x, const float* __restrict__ rh,
      const float* __restrict__ z, const float* __restrict__ w, const float* __restrict__ bias,
      float* __restrict__ out, Geometry g) {
  extern __shared__ float q_smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages];
  constexpr int N = kHidden;
  float* smem = align128(q_smem_raw);
  const int b = blockIdx.y;
  const int r0 = (blockIdx.x / g.col_tiles) * kTileRows;
  const int c0 = (blockIdx.x % g.col_tiles) * kTileCols;
  const size_t plane = (size_t)g.height * g.width;
  gate_sums<AXIS, N>(smem, bars, rh, x, w, g, b, r0, c0, [&](int n) {
    return out + ((size_t)b * kHidden + n) * plane;
  });

  for (int i = threadIdx.x; i < N * kTilePixels; i += Ring<AXIS, N>::kThreads) {
    const int n = i / kTilePixels, p = i % kTilePixels;
    const int row = r0 + p / kTileCols, col = c0 + p % kTileCols;
    if (row >= g.height || col >= g.width) continue;
    const size_t o = ((size_t)b * kHidden + n) * plane + (size_t)row * g.width + col;
    const float q = tanhf(__fadd_rn(__fadd_rn(out[o], smem[n * kTileStride + p]), bias[n]));
    const float zz = z[o], hh = h[o];
    out[o] = __fadd_rn(__fmul_rn(__fsub_rn(1.f, zz), hh), __fmul_rn(zz, q));
  }
}

bool valid(int batch, int height, int width, int cx, int axis) {
  const long long tiles = (long long)((height + kTileRows - 1) / kTileRows) *
                          ((width + kTileCols - 1) / kTileCols);
  return batch >= 1 && batch <= 65535 && height >= 1 && width >= 1 && cx >= kChunk &&
         cx % kChunk == 0 && (axis == 0 || axis == 1) && tiles <= 0x7fffffffLL;
}

dim3 grid(const Geometry& g, int batch) {
  return dim3(g.col_tiles * ((g.height + kTileRows - 1) / kTileRows), batch);
}

template <int AXIS>
int launch_zr(const float* h, const float* x, const float* w, const float* bias, float* z,
              float* rh, const Geometry& g, int batch, cudaStream_t s) {
  using R = Ring<AXIS, 2 * kHidden>;
  static bool smem_allowed = false;
  const cudaError_t err = vst::allow_smem(gru_zr<AXIS>, R::kSmem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  gru_zr<AXIS><<<grid(g, batch), R::kThreads, R::kSmem, s>>>(h, x, w, bias, z, rh, g);
  return (int)cudaGetLastError();
}

template <int AXIS>
int launch_q(const float* h, const float* x, const float* rh, const float* z, const float* w,
             const float* bias, float* out, const Geometry& g, int batch, cudaStream_t s) {
  using R = Ring<AXIS, kHidden>;
  static bool smem_allowed = false;
  const cudaError_t err = vst::allow_smem(gru_q<AXIS>, R::kSmem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  gru_q<AXIS><<<grid(g, batch), R::kThreads, R::kSmem, s>>>(h, x, rh, z, w, bias, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// gru_zr: h (batch, 128, height, width), x (batch, cx, height, width), w (5,
// 128 + cx, 256) and bias (256) as pack_gates writes them; writes z and rh
// (batch, 128, height, width). axis 0: taps 1x5, 1: 5x1. All f32,
// contiguous, 16-byte aligned; cx a multiple of 16. Launches on `stream`;
// returns the launch's cudaError_t (0 on success).
extern "C" int gru_zr_launch(const void* h, const void* x, const void* w, const void* bias,
                             void* z, void* rh, int batch, int height, int width, int cx,
                             int axis, void* stream) {
  if (!valid(batch, height, width, cx, axis)) return (int)cudaErrorInvalidValue;
  const Geometry g{height, width, cx, (width + kTileCols - 1) / kTileCols};
  const auto* hf = static_cast<const float*>(h);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* zf = static_cast<float*>(z);
  auto* rf = static_cast<float*>(rh);
  cudaStream_t s = (cudaStream_t)stream;
  return axis == 0 ? launch_zr<0>(hf, xf, wf, bf, zf, rf, g, batch, s)
                   : launch_zr<1>(hf, xf, wf, bf, zf, rf, g, batch, s);
}

// gru_q: h, rh and z (batch, 128, height, width), x (batch, cx, height,
// width), w (5, 128 + cx, 128) and bias (128); writes out (batch, 128,
// height, width), the new hidden state. As gru_zr_launch otherwise.
extern "C" int gru_q_launch(const void* h, const void* x, const void* rh, const void* z,
                            const void* w, const void* bias, void* out, int batch, int height,
                            int width, int cx, int axis, void* stream) {
  if (!valid(batch, height, width, cx, axis)) return (int)cudaErrorInvalidValue;
  const Geometry g{height, width, cx, (width + kTileCols - 1) / kTileCols};
  const auto* hf = static_cast<const float*>(h);
  const auto* xf = static_cast<const float*>(x);
  const auto* rf = static_cast<const float*>(rh);
  const auto* zf = static_cast<const float*>(z);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  return axis == 0 ? launch_q<0>(hf, xf, rf, zf, wf, bf, of, g, batch, s)
                   : launch_q<1>(hf, xf, rf, zf, wf, bf, of, g, batch, s);
}
