// RAFT correlation-window lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel vst/kernels/pallas_corr.py:_kernel and
// pallas_lookup_level (called through _lookup_forward / pallas_lookup_pyramid).
// Computes what vst_torch.flow.corr.lookup_pyramid computes: for every query q
// and pyramid level l, (2r+1)^2 bilinear samples, with zero padding, of q's own
// (h_l, w_l) correlation map at coords[q] / 2^l + (a - r, b - r), where the X
// offset a varies along the FIRST window axis (channel k = a*(2r+1) + b). The
// Pallas kernel ran each query's window as a row-mask x map matmul on the
// TPU's matrix unit, with bf16 interpolation multiplies; here it is a gather
// in f32 with the plain version's operation order (__fmul_rn / __fadd_rn, no
// FMA contraction), so the two agree bit for bit.
//
// Bound: memory. Per launch it writes Q*L*(2r+1)^2*4 bytes and reads at most
// Q*L*(2r+2)^2*4 bytes of the maps plus Q*8 bytes of coords. At the Sintel
// tcl2 shape (B=4, 54x128 -> Q=27648, L=4, r=4): 35.8 MB written, <= 44.2 MB
// read, ~24 us at 3.35 TB/s (chip_smoke.py: 66.9 MB of this run's windows,
// 0.020 ms). A window row is 10 floats at any 4-byte offset, 2.1 sectors of
// 32 bytes on average: the sectors a run touches come to 86.5 MB (0.026 ms),
// the reads' 1.6x the bytes they need.
//
// Design. The first version of this kernel ran one thread per output (q, l,
// k): five 64-bit divisions and modulos by runtime values per output, the
// query's coordinates and level base reloaded per output, 0.173-0.183 ms at
// the tcl2 shape on the H100. Now one warp owns one query and walks its
// L*(2r+1)^2 outputs (324 at r = 4: 11 rounds of 32 lanes), so
//   - the radius is a template parameter (r = 3, 4: RAFT small and full), and
//     the divisions that split an output index into (level, b, a) are
//     divisions by constants, in 32-bit;
//   - the query's two coordinates are loaded once, and its 64-bit map base
//     per level is computed once, before the walk; an output picks its
//     level's base and size by selects, not by indexing the parameters;
//   - the walk takes the X offset a fastest, so the 32 lanes of a round read
//     about 4 rows of the query's 10x10 patch rather than 10: fewer cache
//     lines a load, and the later rounds find the patch in L1. The results
//     go through shared memory (324 floats a warp) and are stored in the
//     output's order, 32 consecutive floats a store.
// 0.060-0.063 ms on the H100 (700 W) at the tcl2 shape. What is left is the
// maps' scattered reads: with its stores cut to one float a lane the kernel
// takes as long, with its map reads cut 0.020 ms (python -m
// vst_torch.probes.kernel_trials). That is 4x the time of the sectors read
// at the full memory rate, which is what rows of 40 bytes scattered over
// the 0.76 GB of level 0 give; staging each level's patch in shared
// memory first was slower in design trials (it reads an 11x11 patch to
// cover the rounding of x0).
// ptxas: 37-38 registers, no spill, 5 KB of shared memory a block of 4
// warps: 13 blocks, 52 warps an SM.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarps = 4;  // queries a block

struct Pyramid {
  const float* level[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// One bilinear tap: map[yf, xf] * wgt, or 0 when the neighbour lies outside.
__device__ __forceinline__ float tap(const float* __restrict__ map, int h, int w,
                                     float xf, float yf, float wgt) {
  if (xf < 0.f || xf > (float)(w - 1) || yf < 0.f || yf > (float)(h - 1)) {
    return 0.f;
  }
  return __fmul_rn(__ldg(map + (int)yf * w + (int)xf), wgt);
}

template <typename T>
__device__ __forceinline__ T pick(int l, T v0, T v1, T v2, T v3) {
  return l == 0 ? v0 : l == 1 ? v1 : l == 2 ? v2 : v3;
}

template <int R>
__global__ void __launch_bounds__(32 * kWarps)
corr_lookup_kernel(Pyramid pyr, const float* __restrict__ coords, float* __restrict__ out,
                   int num_levels, int hw, int num_queries) {
  constexpr int kN = 2 * R + 1;
  constexpr int kN2 = kN * kN;
  const int q = blockIdx.x * kWarps + threadIdx.x / 32;
  if (q >= num_queries) return;
  const int lane = threadIdx.x % 32;
  const int b = q / hw;
  const float* c = coords + (size_t)b * 2 * hw + (q - b * hw);  // (B, 2, H, W)
  const float cx = __ldg(c);
  const float cy = __ldg(c + hw);
  const float* m0 = pyr.level[0] + (size_t)q * pyr.h[0] * pyr.w[0];
  const float* m1 = pyr.level[1] + (size_t)q * pyr.h[1] * pyr.w[1];
  const float* m2 = pyr.level[2] + (size_t)q * pyr.h[2] * pyr.w[2];
  const float* m3 = pyr.level[3] + (size_t)q * pyr.h[3] * pyr.w[3];
  const int per_query = num_levels * kN2;
  float* o = out + (size_t)q * per_query;
  __shared__ float buf[kWarps][kMaxLevels * kN2];
  float* bw = buf[threadIdx.x / 32];
  for (int j = lane; j < per_query; j += 32) {
    const int l = j / kN2;
    const int kt = j - l * kN2;  // b * kN + a: neighbouring lanes, neighbouring x
    const int bb = kt / kN;
    const int a = kt - bb * kN;
    const int k = a * kN + bb;
    const float inv = __int_as_float((127 - l) << 23);  // 2^-l, exact
    const float x = __fadd_rn(__fmul_rn(cx, inv), (float)(a - R));
    const float y = __fadd_rn(__fmul_rn(cy, inv), (float)(k - a * kN - R));
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float wx1 = __fsub_rn(x, x0);
    const float wy1 = __fsub_rn(y, y0);
    const float wx0 = __fsub_rn(1.f, wx1);
    const float wy0 = __fsub_rn(1.f, wy1);
    const int h = pick(l, pyr.h[0], pyr.h[1], pyr.h[2], pyr.h[3]);
    const int w = pick(l, pyr.w[0], pyr.w[1], pyr.w[2], pyr.w[3]);
    const float* map = pick(l, m0, m1, m2, m3);
    float s = tap(map, h, w, x0, y0, __fmul_rn(wy0, wx0));
    s = __fadd_rn(s, tap(map, h, w, x0 + 1.f, y0, __fmul_rn(wy0, wx1)));
    s = __fadd_rn(s, tap(map, h, w, x0, y0 + 1.f, __fmul_rn(wy1, wx0)));
    s = __fadd_rn(s, tap(map, h, w, x0 + 1.f, y0 + 1.f, __fmul_rn(wy1, wx1)));
    bw[l * kN2 + k] = s;
  }
  __syncwarp();
  for (int j = lane; j < per_query; j += 32) o[j] = bw[j];
}

}  // namespace

// levels: num_levels device pointers to (Q, h_l, w_l) f32 maps, the rest null.
// coords: (B, 2, H, W) f32 with Q = B*H*W and hw = H*W. radius: 3 or 4.
// out: (Q, num_levels*(2r+1)^2) f32. Launches on `stream`; returns the
// launch's cudaError_t (0 on success).
extern "C" int corr_lookup_launch(const float* level0, const float* level1,
                                  const float* level2, const float* level3,
                                  const int* heights, const int* widths,
                                  int num_levels, const float* coords, float* out,
                                  long long num_queries, long long hw, int radius,
                                  void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || (radius != 3 && radius != 4) ||
      hw <= 0 || num_queries % hw != 0 || num_queries >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  Pyramid pyr;
  const float* levels[kMaxLevels] = {level0, level1, level2, level3};
  for (int l = 0; l < kMaxLevels; ++l) {
    pyr.level[l] = l < num_levels ? levels[l] : level0;
    pyr.h[l] = l < num_levels ? heights[l] : 0;
    pyr.w[l] = l < num_levels ? widths[l] : 0;
  }
  if (num_queries == 0) {
    return (int)cudaSuccess;
  }
  const unsigned blocks = (unsigned)((num_queries + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  if (radius == 3) {
    corr_lookup_kernel<3><<<blocks, 32 * kWarps, 0, s>>>(pyr, coords, out, num_levels, (int)hw,
                                                         (int)num_queries);
  } else {
    corr_lookup_kernel<4><<<blocks, 32 * kWarps, 0, s>>>(pyr, coords, out, num_levels, (int)hw,
                                                         (int)num_queries);
  }
  return (int)cudaGetLastError();
}
