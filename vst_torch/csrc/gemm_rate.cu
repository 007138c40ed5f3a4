// In-kernel matrix-product rate probe for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/bisect_mxu.py:make (pallas_call :28):
// y = sum_{rep < reps} x @ w with the reps loop inside the kernel, y cast to
// x's dtype once. x (M, K), w (K, N), y (M, N), row-major, all f32 or all
// bf16.
//
// Bound: operations. At M = 4096, K = N = 128, reps = 64: 8.59 GFLOP against
// 2.2 MB (f32) moved, 0.128 ms at 67 TFLOP/s SIMT f32 and 0.0087 ms at
// 989 TFLOP/s bf16. What keeps a kernel from it is re-reading x and w from
// L2 on every rep, so both paths keep the CTA's operands in shared memory
// for all reps where they fit (the counterpart of the TPU probe's operands
// resident in VMEM) and stream K chunks through a ring where they do not.
//
// bf16: warpgroup wgmma (m64n64k16 or m64n128k16, f32 accumulators in
//   registers) on operands in 128-byte-swizzled shared memory, loaded by
//   TMA (zero fill past M, K and N). A CTA owns a 64 x BN tile of y: BN =
//   128 where 64 x 128 tiles still give at least 132 CTAs (one per SM), else
//   64. At M = 4096: N = 128 and 256 get BN = 64 (128 and 256 CTAs), N = 512
//   and 1024 get BN = 128 (256 and 512 CTAs). x is K-major (wgmma's A as
//   stored); w is N-major (B transposed in the instruction), each 64-wide N
//   atom a separate TMA box. One producer warp issues the TMA loads; 2 or 3
//   consumer warpgroups split the (rep, K atom) steps between them, so that
//   their wgmma chains overlap (one warpgroup's chain of m64n64 products
//   leaves the tensor cores idle between them), and sum their partial tiles
//   at the end: 3 where an SM holds one CTA, 2 where it holds several. Three plans,
//   by shared memory (227 KB):
//     resident: all of x's and w's tiles loaded once (K <= 768 at BN = 64,
//       <= 512 at BN = 128); all reps run from shared memory.
//     stream x: w's tile resident, x's K atoms (64 x 64, 8 KB) through a
//       6-stage ring that the producer keeps filled (full / empty
//       mbarriers), so the L2 reads of the next atoms overlap the products
//       of this one (K = 1152: 144 KB of w + 48 KB of ring).
//     stream both: each ring stage holds an x atom and w's atoms (K past
//       about 1400 at BN = 64).
//   f32 accumulation: with bf16 inputs the f32 sums' rounding is far inside
//   the bf16 output's ulp, so each warpgroup keeps one accumulator over its
//   steps.
// f32 (TF32 off): SIMT FMA. 256 threads own a 64 x 64 tile in two groups of
//   128, one for each K half of every chunk (8 warps an SM where one warp a
//   scheduler left FMA latency showing), each thread 4 rows x 8 columns (2 x
//   4 contiguous), the two groups' sums added at the end. Chunks are staged
//   by cp.async: all chunks of 64 k once where they fit (K <= 448); else
//   chunks of 128 k through a 3-stage ring with one barrier per chunk, w's
//   chunks resident where they fit (K <= 512). x rows are 128 bytes with
//   16-byte groups swizzled by row, so the float4 reads of 4 rows hit 4 bank
//   groups. Each rep is summed in its own registers and added to the
//   accumulator, as the script's acc + dot, which keeps f32 rounding that
//   of K-long sums plus reps adds.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from the CUDA driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kBM = 64;

// ---- bf16: wgmma ----

constexpr int kAtomK = 64;             // K per 128-byte swizzle atom
constexpr int kBoxBytes = 64 * 128;    // one TMA box: 64 rows x 64 bf16
constexpr int kStages = 6;
constexpr int kBarBytes = (2 * kStages + 2) * 8;

struct Plan {
  int bn, consumers, katoms, x_stream, w_stream, smem;
};

// byte offsets inside the 1024-aligned dynamic shared memory; the final
// sum of the warpgroups' partial tiles reuses the operands' memory
struct Layout {
  uint32_t wres, xres, ring, stage, bars;
  __host__ __device__ Layout(const Plan& p) {
    const int na = p.bn / 64;
    const uint32_t wbytes = p.w_stream ? 0 : p.katoms * na * kBoxBytes;
    const uint32_t xbytes = p.x_stream ? 0 : p.katoms * kBoxBytes;
    stage = kBoxBytes * (1 + (p.w_stream ? na : 0));
    wres = 0;
    xres = wbytes;
    ring = wbytes + xbytes;
    const uint32_t operands = ring + (p.x_stream ? kStages * stage : 0);
    const uint32_t partials = (p.consumers - 1) * 64 * p.bn * 4;
    bars = operands > partials ? operands : partials;
  }
};

// BN = 128 where it still gives one CTA per SM, else 64; then the first
// of resident, stream x, stream both that fits in shared memory. Consumer
// warpgroups: 3 where an SM holds one CTA (BN = 64 has N = 128 or 256 and
// 128 or 256 CTAs; or the operands take over half the shared memory),
// else 2 (BN = 128 with small operands, two or more CTAs an SM).
Plan make_plan(int M, int N, int K) {
  Plan p{};
  p.katoms = (K + kAtomK - 1) / kAtomK;
  const int row_tiles = (M + kBM - 1) / kBM;
  p.bn = (N > 64 && row_tiles * ((N + 127) / 128) >= 132) ? 128 : 64;
  p.consumers = 3;  // the most partial tiles the final sum may hold
  for (;; p.bn = 64) {
    for (int mode = 0; mode < 3; ++mode) {
      p.x_stream = mode >= 1;
      p.w_stream = mode == 2;
      p.smem = Layout(p).bars + kBarBytes + 1024;  // + alignment to 1024
      if (p.smem <= kSmemLimit && (mode < 2 || p.bn == 64)) {
        p.consumers = (p.bn == 64 || p.smem > kSmemLimit / 2) ? 3 : 2;
        p.smem = Layout(p).bars + kBarBytes + 1024;
        return p;
      }
    }
  }
}

template <int C>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * C) : "memory");
}

// Steps are (rep, K atom) pairs in order; consumer warpgroup c of C takes
// steps c, c + C, ..., so the warpgroups' wgmma chains run side by side, and
// their partial tiles are summed at the end. Warp 4 C is the producer.
template <int BN, int C>
__global__ void __launch_bounds__(128 * C + 32)
gemm_rate_bf16(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               __nv_bfloat16* __restrict__ y, int M, int N, int K, int reps, Plan plan) {
  constexpr int kNA = BN / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (vst::smem_addr(smem_raw) + 1023) & ~1023u;
  const Layout lay(plan);
  const uint32_t full = base + lay.bars;        // kStages barriers
  const uint32_t empty = full + 8 * kStages;    // kStages barriers
  const uint32_t bar_w = empty + 8 * kStages;
  const uint32_t bar_x = bar_w + 8;

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * BN;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int steps = reps * plan.katoms;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      vst::mbar_init(full + 8 * s, 1);
      vst::mbar_init(empty + 8 * s, 4);  // lane 0 of each warp of the consuming warpgroup
    }
    vst::mbar_init(bar_w, 1);
    vst::mbar_init(bar_x, 1);
    vst::mbar_fence_init();
  }
  __syncthreads();

  if (wg == C) {  // producer: one thread issues every TMA load
    if (threadIdx.x != 128 * C) return;
    if (!plan.w_stream) {
      vst::mbar_expect_tx(bar_w, plan.katoms * kNA * kBoxBytes);
      for (int ka = 0; ka < plan.katoms; ++ka)
        for (int a = 0; a < kNA; ++a)
          vst::tma_load_2d(base + lay.wres + (ka * kNA + a) * kBoxBytes, &wmap, bar_w, n0 + 64 * a,
                           ka * kAtomK);
    }
    if (!plan.x_stream) {
      vst::mbar_expect_tx(bar_x, plan.katoms * kBoxBytes);
      for (int ka = 0; ka < plan.katoms; ++ka)
        vst::tma_load_2d(base + lay.xres + ka * kBoxBytes, &xmap, bar_x, ka * kAtomK, m0);
      return;
    }
    for (int step = 0; step < steps; ++step) {
      const int s = step % kStages;
      const int ka = step % plan.katoms;
      if (step >= kStages) vst::mbar_wait(empty + 8 * s, ((step / kStages) - 1) & 1);
      const uint32_t dst = base + lay.ring + s * lay.stage;
      vst::mbar_expect_tx(full + 8 * s, lay.stage);
      vst::tma_load_2d(dst, &xmap, full + 8 * s, ka * kAtomK, m0);
      if (plan.w_stream)
        for (int a = 0; a < kNA; ++a)
          vst::tma_load_2d(dst + (1 + a) * kBoxBytes, &wmap, full + 8 * s, n0 + 64 * a,
                           ka * kAtomK);
    }
    return;
  }

  // consumer warpgroup wg: warp w holds rows 16w .. 16w + 15 of the tile
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  vst::fence_operands(d);
  if (!plan.w_stream) vst::mbar_wait(bar_w, 0);
  if (!plan.x_stream) vst::mbar_wait(bar_x, 0);

  for (int step = wg; step < steps; step += C) {
    const int s = step % kStages;
    const int ka = step % plan.katoms;
    uint32_t xa, wa;
    if (plan.x_stream) {
      vst::mbar_wait(full + 8 * s, (step / kStages) & 1);
      xa = base + lay.ring + s * lay.stage;
      wa = plan.w_stream ? xa + kBoxBytes : base + lay.wres + ka * kNA * kBoxBytes;
    } else {
      xa = base + lay.xres + ka * kBoxBytes;
      wa = base + lay.wres + ka * kNA * kBoxBytes;
    }
    const int ksteps = min(4, (K - ka * kAtomK + 15) / 16);
    vst::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < ksteps) {
        const uint64_t da = vst::desc_sw128(xa + 32 * kk, 16, 1024);
        const uint64_t db = vst::desc_sw128(wa + 2048 * kk, kBoxBytes, 1024);
        if constexpr (BN == 64) {
          vst::wgmma_m64n64k16_ss(d, da, db);
        } else {
          vst::wgmma_m64n128k16_ss(d, da, db);
        }
      }
    }
    vst::wgmma_commit();
    if (plan.x_stream) {  // this warpgroup's previous step is done with its stage
      vst::wgmma_wait<1>();
      if (step >= C && lane == 0) vst::mbar_arrive(empty + 8 * ((step - C) % kStages));
    }
  }
  vst::wgmma_wait<0>();
  vst::fence_operands(d);

  // warpgroups 1.. hand their partial tiles to warpgroup 0 through shared memory
  float* partials = reinterpret_cast<float*>(smem_raw + (base - vst::smem_addr(smem_raw)));
  const int t = threadIdx.x % 128;
  consumer_sync<C>();  // every warpgroup's products are done with the operands
  if (wg > 0) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) partials[((wg - 1) * (BN / 2) + i) * 128 + t] = d[i];
  }
  consumer_sync<C>();
  if (wg > 0) return;
  for (int c = 1; c < C; ++c) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] += partials[((c - 1) * (BN / 2) + i) * 128 + t];
  }

  const int r = m0 + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane % 4);
    if (c >= N) continue;
    if (r < M)
      *reinterpret_cast<unsigned*>(y + (size_t)r * N + c) = vst::pack_bf16x2(d[4 * j], d[4 * j + 1]);
    if (r + 8 < M)
      *reinterpret_cast<unsigned*>(y + (size_t)(r + 8) * N + c) =
          vst::pack_bf16x2(d[4 * j + 2], d[4 * j + 3]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a bf16 (rows, cols) row-major matrix read in 64 x 64 boxes, 128-byte swizzle
bool box_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int BN, int C>
int launch_bf16(const void* x, const void* w, void* y, int M, int N, int K, int reps,
                const Plan& plan, cudaStream_t s) {
  CUtensorMap xmap, wmap;
  if (!box_map(&xmap, x, M, K) || !box_map(&wmap, w, K, N)) return (int)cudaErrorInvalidValue;
  static bool smem_allowed = false;
  const cudaError_t err = vst::allow_smem(gemm_rate_bf16<BN, C>, kSmemLimit, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + kBM - 1) / kBM);
  gemm_rate_bf16<BN, C><<<grid, 128 * C + 32, plan.smem, s>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(y), M, N, K, reps, plan);
  return (int)cudaGetLastError();
}

// ---- f32: SIMT ----

constexpr int kF32Stages = 3;
constexpr int kF32Threads = 256;  // two groups of 128, one per K half

// A chunk of BK k: x as [BK / 32][64 rows][32 k] (128-byte rows), w as
// [BK k][64 n]. Each thread group takes one K half of every chunk.
template <int BK>
struct Chunk {
  static constexpr int kSubs = BK / 32;
  static constexpr int kXFloats = kSubs * kBM * 32;
  static constexpr int kWFloats = BK * 64;
};
enum F32Plan { kResident = 0, kStreamX = 1, kStreamBoth = 2 };

// chunk kc of the CTA's x rows into `xs`, of its w columns into `ws`
// (shared), zero past M, K, N
template <int BK>
__device__ __forceinline__ void load_x(float* xs, const float* __restrict__ x, int M, int K, int m0,
                                       int kc) {
#pragma unroll
  for (int q = 0; q < BK / 16; ++q) {  // 64 rows x BK / 4 groups of 4
    const int i = threadIdx.x + q * kF32Threads;
    const int r = i / (BK / 4), g = i % (BK / 4);
    const int k = kc * BK + 4 * g;
    const bool ok = m0 + r < M && k < K;
    const float* src = ok ? x + (size_t)(m0 + r) * K + k : x;
    vst::cp_async16(vst::smem_addr(xs + (g / 8) * kBM * 32) + vst::swizzle128(r, g % 8), src,
                    ok ? 16 : 0);
  }
}

template <int BK>
__device__ __forceinline__ void load_w(float* ws, const float* __restrict__ w, int N, int K, int n0,
                                       int kc) {
#pragma unroll
  for (int q = 0; q < BK / 16; ++q) {  // BK k x 16 groups of 4
    const int i = threadIdx.x + q * kF32Threads;
    const int kk = i / 16, g = i % 16;
    const int k = kc * BK + kk;
    const bool ok = k < K && n0 + 4 * g < N;
    const float* src = ok ? w + (size_t)k * N + n0 + 4 * g : w;
    vst::cp_async16(vst::smem_addr(ws + kk * 64 + 4 * g), src, ok ? 16 : 0);
  }
}

// part[i][j] += x[ty + 16 i][k] * w[k][cols j] over one block of 32 k
__device__ __forceinline__ void sub_product(const float* xs, const float* wh, int tx, int ty,
                                            float (&part)[4][8]) {
  const unsigned char* xh = reinterpret_cast<const unsigned char*>(xs);
#pragma unroll
  for (int kq = 0; kq < 8; ++kq) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(xh + vst::swizzle128(ty + 16 * i, kq));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(wh + (4 * kq + kk) * 64 + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(wh + (4 * kq + kk) * 64 + 32 + 4 * tx);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(av, bv[j], part[i][j]);
      }
    }
  }
}

// part[i][j] += x[ty + 16 i][k] * w[k][cols j] over the k of this group's
// half of the chunk, 32 at a time
template <int BK>
__device__ __forceinline__ void half_product(const float* xs, const float* ws, int half, int tx,
                                             int ty, float (&part)[4][8]) {
  constexpr int kHalf = Chunk<BK>::kSubs / 2;
#pragma unroll
  for (int sub = half * kHalf; sub < (half + 1) * kHalf; ++sub) {
    sub_product(xs + sub * kBM * 32, ws + sub * 32 * 64, tx, ty, part);
  }
}

__device__ __forceinline__ void zero(float (&v)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
}

__device__ __forceinline__ void add(float (&acc)[4][8], const float (&part)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
}

// Shared memory by plan: resident, every chunk's x then w; stream x, w's
// chunks then a ring of x chunks; stream both, a ring of (x, w) chunks.
template <int BK>
__global__ void __launch_bounds__(kF32Threads)
gemm_rate_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
              int M, int N, int K, int reps, int plan) {
  constexpr int kXFloats = Chunk<BK>::kXFloats;
  constexpr int kWFloats = Chunk<BK>::kWFloats;
  extern __shared__ __align__(1024) float fsmem[];
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * 64;
  const int half = threadIdx.x / 128;  // this group's K half of every chunk
  const int t = threadIdx.x % 128;
  const int tx = t % 8;  // columns 4 tx .. + 3 and 32 + 4 tx .. + 3
  const int ty = t / 8;  // rows ty + 16 i
  const int chunks = (K + BK - 1) / BK;
  float acc[4][8], part[4][8];
  zero(acc);

  if (plan == kResident) {
    for (int kc = 0; kc < chunks; ++kc) {
      float* c = fsmem + kc * (kXFloats + kWFloats);
      load_x<BK>(c, x, M, K, m0, kc);
      load_w<BK>(c + kXFloats, w, N, K, n0, kc);
    }
    vst::cp_async_commit();
    vst::cp_async_wait<0>();
    __syncthreads();
    for (int rep = 0; rep < reps; ++rep) {
      zero(part);
      for (int kc = 0; kc < chunks; ++kc) {
        const float* c = fsmem + kc * (kXFloats + kWFloats);
        half_product<BK>(c, c + kXFloats, half, tx, ty, part);
      }
      add(acc, part);
    }
  } else {
    const bool w_resident = plan == kStreamX;
    float* ring = w_resident ? fsmem + chunks * kWFloats : fsmem;
    const int stage = w_resident ? kXFloats : kXFloats + kWFloats;
    if (w_resident)
      for (int kc = 0; kc < chunks; ++kc) load_w<BK>(fsmem + kc * kWFloats, w, N, K, n0, kc);
    const int steps = reps * chunks;
#pragma unroll
    for (int s = 0; s < kF32Stages - 1; ++s) {  // w's chunks join the first group
      if (s < steps) {
        load_x<BK>(ring + s * stage, x, M, K, m0, s % chunks);
        if (!w_resident) load_w<BK>(ring + s * stage + kXFloats, w, N, K, n0, s % chunks);
      }
      vst::cp_async_commit();
    }
    for (int step = 0; step < steps; ++step) {
      vst::cp_async_wait<kF32Stages - 2>();  // this step's chunk has landed
      __syncthreads();                        // and every thread is done with the stage refilled below
      const int next = step + kF32Stages - 1;
      if (next < steps) {
        float* c = ring + (next % kF32Stages) * stage;
        load_x<BK>(c, x, M, K, m0, next % chunks);
        if (!w_resident) load_w<BK>(c + kXFloats, w, N, K, n0, next % chunks);
      }
      vst::cp_async_commit();
      const int kc = step % chunks;
      if (kc == 0) zero(part);
      const float* c = ring + (step % kF32Stages) * stage;
      half_product<BK>(c, w_resident ? fsmem + kc * kWFloats : c + kXFloats, half, tx, ty, part);
      if (kc == chunks - 1) add(acc, part);
    }
    vst::cp_async_wait<0>();
  }

  // the second group hands its sum to the first through shared memory
  __syncthreads();
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) fsmem[(i * 8 + j) * 128 + t] = acc[i][j];
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] += fsmem[(i * 8 + j) * 128 + t];

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + 32 * h + 4 * tx;
      if (c < N) {
        *reinterpret_cast<float4*>(y + (size_t)r * N + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
    }
  }
}

template <int BK>
int launch_f32_plan(const float* x, const float* w, float* y, int M, int N, int K, int reps, int plan,
                    int smem, cudaStream_t s) {
  static bool smem_allowed = false;
  const cudaError_t err = vst::allow_smem(gemm_rate_f32<BK>, kSmemLimit, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + 63) / 64, (M + kBM - 1) / kBM);
  gemm_rate_f32<BK><<<grid, kF32Threads, smem, s>>>(x, w, y, M, N, K, reps, plan);
  return (int)cudaGetLastError();
}

// resident in chunks of 64 k where every chunk fits (K <= 448); else
// chunks of 128 k, which halve the barriers per k, with w resident where it
// fits (K <= 512) and both streamed past that
int launch_f32(const float* x, const float* w, float* y, int M, int N, int K, int reps,
               cudaStream_t s) {
  using C64 = Chunk<64>;
  using C128 = Chunk<128>;
  const int chunks64 = (K + 63) / 64;
  const int resident = chunks64 * (C64::kXFloats + C64::kWFloats) * 4;
  if (resident <= kSmemLimit) return launch_f32_plan<64>(x, w, y, M, N, K, reps, kResident, resident, s);
  const int chunks = (K + 127) / 128;
  const int stream_x = (chunks * C128::kWFloats + kF32Stages * C128::kXFloats) * 4;
  if (stream_x <= kSmemLimit) return launch_f32_plan<128>(x, w, y, M, N, K, reps, kStreamX, stream_x, s);
  return launch_f32_plan<128>(x, w, y, M, N, K, reps, kStreamBoth,
                              kF32Stages * (C128::kXFloats + C128::kWFloats) * 4, s);
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
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16) {
    return launch_f32(static_cast<const float*>(x), static_cast<const float*>(w),
                      static_cast<float*>(y), M, N, K, reps, s);
  }
  const Plan plan = make_plan(M, N, K);
  if (plan.bn == 64) return launch_bf16<64, 3>(x, w, y, M, N, K, reps, plan, s);
  return plan.consumers == 3 ? launch_bf16<128, 3>(x, w, y, M, N, K, reps, plan, s)
                             : launch_bf16<128, 2>(x, w, y, M, N, K, reps, plan, s);
}
