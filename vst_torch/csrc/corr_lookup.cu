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
//
// The backward, lookup_grad_kernel below, replaces no TPU kernel: the Pallas
// kernel had no backward (pallas_corr.py:_lookup_bwd recomputes through the
// plain version's VJP). Its note gives its bound and design.

#include <cstdint>

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


// Backward of the lookup: each level's dense gradient and, when asked, the
// coordinates' gradient, what lookup_pyramid's autograd computes.
//
// Bound: memory. The dense gradient is written whole, one float a query and
// level pixel, and the window gradient read once: Q*(sum_l h_l*w_l +
// L*(2r+1)^2 + 2)*4 bytes at the op's boundary. At RAFT's chairs stage
// (B=10, 46x62 -> Q=28520, levels 46x62, 23x31, 11x15, 5x7, r=4) that is
// 429.5 MB written and 37.0 MB read: 466.7 MB, 0.139 ms at 3.35 TB/s. The
// plain autograd took 20.1 ms: it recomputes the forward with int64 indices,
// zero-fills each level, sorts 4*(2r+1)^2 indices a query and scatters them.
//
// Design. A block of 8 warps owns 8 consecutive queries (a tile), whose maps
// are one contiguous run of 8*h_l*w_l floats at every level, 32-byte aligned
// at its start (the tile's first query is a multiple of 8, the maps' base is
// aligned), so
//   - the block loads the tile's window gradients into shared memory once,
//     neighbouring threads on neighbouring addresses in either layout the
//     gradient arrives in (channel-last or NCHW: query or channel fastest);
//   - warp t gathers query t's patch at each level: the (2r+3)^2 pixels its
//     taps' bilinear corners can touch (x0 = floor(x/2^l + a - r) is
//     floor(x/2^l) - r + a, or one more where the sum rounds up to an
//     integer). Each patch pixel sums, in a fixed order, the at most 3x3
//     taps whose corners may land on it, grad * (wy * wx) with the weights
//     computed as the forward computes them (__fmul_rn / __fadd_rn), so two
//     runs give equal bits and no atomics are needed;
//   - the block then writes each level's run once, 16-byte streaming stores
//     (scalars at a ragged end of the last tile), zeros and patch values
//     together: no separate zero fill, no sort, no index tensors. A thread
//     steps its chunk's query and offset by subtraction, and looks a patch
//     up only for a chunk that meets one (a division a chunk and a lookup a
//     float took 0.268 ms at the chairs shape);
//   - the coordinates' gradient (RAFT detaches its coordinates, so training
//     never asks for it) is warp t's sum over its query's taps of the
//     derivative through wx1 and wy1, reading each tap's 4 corners of the
//     maps as the forward does, reduced by shuffles in a fixed order.
// 0.247 ms at the chairs shape on the H100 (700 W): 56 % of the bound, 82x
// faster than the plain autograd (20.2 ms).
// ptxas: 32 registers, no spill; 31,552 bytes of shared memory a block of 8
// warps at r = 4 (21,184 at r = 3).

constexpr int kGradQueries = 8;  // queries a block, one warp each

struct GradLevels {
  const float* map[kMaxLevels];  // read for the coordinates' gradient only
  float* dmap[kMaxLevels];       // each level's dense gradient; null: not wanted
  int h[kMaxLevels];
  int w[kMaxLevels];
};

template <int R>
__global__ void __launch_bounds__(32 * kGradQueries)
lookup_grad_kernel(GradLevels lv, const float* __restrict__ coords,
                   const float* __restrict__ grad, long long grad_sb, long long grad_sp,
                   long long grad_sc, float* __restrict__ dcoords, int num_levels, int hw,
                   int num_queries) {
  constexpr int kN = 2 * R + 1;
  constexpr int kN2 = kN * kN;
  constexpr int kP = 2 * R + 3;  // a patch's side
  constexpr int kP2 = kP * kP;
  __shared__ float g_s[kGradQueries][kMaxLevels * kN2];     // window gradients
  __shared__ float patch_s[kGradQueries][kMaxLevels][kP2];  // dense gradient near each window
  __shared__ float wt_s[kGradQueries][kMaxLevels][2][2][kN];  // [axis x, y][w0, w1][tap]
  __shared__ signed char off_s[kGradQueries][kMaxLevels][2][kN];  // corner 0 - patch origin
  __shared__ int box_s[kGradQueries][kMaxLevels][4];  // patch origin x, y; flat range lo, hi

  const int q0 = blockIdx.x * kGradQueries;
  const int nq = min(kGradQueries, num_queries - q0);
  const int channels = num_levels * kN2;
  const int tid = threadIdx.x;
  if (grad_sc <= grad_sp) {  // channel fastest
    for (int i = tid; i < nq * channels; i += blockDim.x) {
      const int t = i / channels;
      const int k = i - t * channels;
      const int q = q0 + t;
      const int b = q / hw;
      g_s[t][k] = __ldg(grad + b * grad_sb + (q - b * hw) * grad_sp + k * grad_sc);
    }
  } else {  // query fastest
    for (int i = tid; i < kGradQueries * channels; i += blockDim.x) {
      const int k = i / kGradQueries;
      const int t = i % kGradQueries;
      const int q = q0 + t;
      const int b = q / hw;
      if (t < nq) g_s[t][k] = __ldg(grad + b * grad_sb + (q - b * hw) * grad_sp + k * grad_sc);
    }
  }
  __syncthreads();

  const int t = tid / 32;
  const int lane = tid % 32;
  if (t < nq) {
    const int q = q0 + t;
    const int b = q / hw;
    const int p = q - b * hw;
    const float cx = __ldg(coords + (size_t)b * 2 * hw + p);
    const float cy = __ldg(coords + (size_t)b * 2 * hw + hw + p);
    // per level and axis: each tap's corner-0 offset from the patch origin
    // (a, or a + 1 where x/2^l + a - r rounds up to an integer) and weights
    for (int i = lane; i < num_levels * 2 * kN; i += 32) {
      const int l = i / (2 * kN);
      const int axis = (i / kN) % 2;
      const int a = i % kN;
      const float inv = __int_as_float((127 - l) << 23);  // 2^-l, exact
      const float c = __fmul_rn(axis ? cy : cx, inv);
      const float x = __fadd_rn(c, (float)(a - R));
      const float x0 = floorf(x);
      const float w1 = __fsub_rn(x, x0);
      wt_s[t][l][axis][0][a] = __fsub_rn(1.f, w1);
      wt_s[t][l][axis][1][a] = w1;
      // clamped: outside the map the offset is never read (and a float
      // outside the int range would not convert)
      off_s[t][l][axis][a] = (signed char)fminf(fmaxf(x0 - (floorf(c) - R), -2.f), (float)kP);
    }
    if (lane < num_levels) {
      const int l = lane;
      const float inv = __int_as_float((127 - l) << 23);
      const float ox = floorf(__fmul_rn(cx, inv)) - R;
      const float oy = floorf(__fmul_rn(cy, inv)) - R;
      const int map_h = pick(l, lv.h[0], lv.h[1], lv.h[2], lv.h[3]);
      const int map_w = pick(l, lv.w[0], lv.w[1], lv.w[2], lv.w[3]);
      int* box = box_s[t][l];
      // the patch meets the map
      if (ox > -kP && ox < (float)map_w && oy > -kP && oy < (float)map_h) {
        box[0] = (int)ox;
        box[1] = (int)oy;
        box[2] = box[1] * map_w + box[0];
        box[3] = (box[1] + kP - 1) * map_w + box[0] + kP;
      } else {
        box[0] = box[1] = box[2] = box[3] = 0;  // an empty range: the map's gradient is 0
      }
    }
    __syncwarp();
    // the patch, gathered: pixel (dy, dx) takes the taps b in dy-2..dy,
    // a in dx-2..dx whose corners land on it, in a fixed order
    for (int i = lane; i < num_levels * kP2; i += 32) {
      const int l = i / kP2;
      if (box_s[t][l][2] == box_s[t][l][3]) continue;  // never read
      const int dy = (i % kP2) / kP;
      const int dx = i % kP;
      const float* gq = g_s[t] + l * kN2;
      float s = 0.f;
#pragma unroll
      for (int bi = 0; bi < 3; ++bi) {
        const int bb = dy - 2 + bi;
        if (bb < 0 || bb >= kN) continue;
        const int oy = off_s[t][l][1][bb];
        if (oy != dy && oy + 1 != dy) continue;
        const float wy = wt_s[t][l][1][oy == dy ? 0 : 1][bb];
#pragma unroll
        for (int ai = 0; ai < 3; ++ai) {
          const int a = dx - 2 + ai;
          if (a < 0 || a >= kN) continue;
          const int ox = off_s[t][l][0][a];
          if (ox != dx && ox + 1 != dx) continue;
          const float wx = wt_s[t][l][0][ox == dx ? 0 : 1][a];
          s = __fadd_rn(s, __fmul_rn(gq[a * kN + bb], __fmul_rn(wy, wx)));
        }
      }
      patch_s[t][l][i % kP2] = s;
    }
    if (dcoords != nullptr) {
      // d out / d x through wx1 and d out / d y through wy1, each tap's 4
      // corners read as the forward reads them, times 2^-l
      float gx = 0.f;
      float gy = 0.f;
      for (int j = lane; j < channels; j += 32) {
        const int l = j / kN2;
        const int a = (j % kN2) / kN;
        const int bb = j % kN;
        const int* box = box_s[t][l];
        if (box[2] == box[3]) continue;  // every corner outside the map
        const int map_h = pick(l, lv.h[0], lv.h[1], lv.h[2], lv.h[3]);
        const int map_w = pick(l, lv.w[0], lv.w[1], lv.w[2], lv.w[3]);
        const float* map =
            pick(l, lv.map[0], lv.map[1], lv.map[2], lv.map[3]) + (size_t)q * map_h * map_w;
        const int x0 = box[0] + off_s[t][l][0][a];
        const int y0 = box[1] + off_s[t][l][1][bb];
        const float wx0 = wt_s[t][l][0][0][a], wx1 = wt_s[t][l][0][1][a];
        const float wy0 = wt_s[t][l][1][0][bb], wy1 = wt_s[t][l][1][1][bb];
        const bool in_x0 = x0 >= 0 && x0 < map_w, in_x1 = x0 + 1 >= 0 && x0 + 1 < map_w;
        const bool in_y0 = y0 >= 0 && y0 < map_h, in_y1 = y0 + 1 >= 0 && y0 + 1 < map_h;
        const float g = g_s[t][j];
        const float* m = map + y0 * map_w + x0;  // corner (y0, x0), read only inside the map
        const float m00 = in_y0 && in_x0 ? __fmul_rn(g, __ldg(m)) : 0.f;
        const float m01 = in_y0 && in_x1 ? __fmul_rn(g, __ldg(m + 1)) : 0.f;
        const float m10 = in_y1 && in_x0 ? __fmul_rn(g, __ldg(m + map_w)) : 0.f;
        const float m11 = in_y1 && in_x1 ? __fmul_rn(g, __ldg(m + map_w + 1)) : 0.f;
        const float inv = __int_as_float((127 - l) << 23);
        gx += inv * ((m01 - m00) * wy0 + (m11 - m10) * wy1);
        gy += inv * ((m10 - m00) * wx0 + (m11 - m01) * wx1);
      }
#pragma unroll
      for (int m = 16; m > 0; m /= 2) {
        gx += __shfl_xor_sync(0xffffffffu, gx, m);
        gy += __shfl_xor_sync(0xffffffffu, gy, m);
      }
      if (lane == 0) {
        dcoords[(size_t)b * 2 * hw + p] = gx;
        dcoords[(size_t)b * 2 * hw + hw + p] = gy;
      }
    }
  }
  __syncthreads();

  // each level's run of the tile's maps, written once
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= num_levels || lv.dmap[l] == nullptr) continue;
    const int w = lv.w[l];
    const int hwl = lv.h[l] * w;
    float* out = lv.dmap[l] + (size_t)q0 * hwl;
    const int n = nq * hwl;
    // the value at offset f of the run: query f / hwl's patch, or 0
    auto value = [&](int tq, int rem) -> float {
      const int* box = box_s[tq][l];
      if (rem < box[2] || rem >= box[3]) return 0.f;
      const int y = rem / w;
      const int dx = rem - y * w - box[0];
      const int dy = y - box[1];
      return (unsigned)dx < (unsigned)kP && (unsigned)dy < (unsigned)kP
                 ? patch_s[tq][l][dy * kP + dx] : 0.f;
    };
    // this thread's chunk of 4 starts at offset rem of query tq's map; a
    // chunk that misses its query's patch and ends inside its map is zeros
    const int step = 4 * blockDim.x;
    int tq = 4 * tid / hwl;
    int rem = 4 * tid - tq * hwl;
    for (int f = 4 * tid; f + 4 <= n; f += step) {
      const int* box = box_s[tq][l];
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if ((rem + 4 > box[2] && rem < box[3]) || rem + 4 > hwl) {
        int tv = tq;
        int rv = rem;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = value(tv, rv);
          if (++rv == hwl) {
            rv = 0;
            ++tv;
          }
        }
      }
      __stcs(reinterpret_cast<float4*>(out + f), make_float4(v[0], v[1], v[2], v[3]));
      for (rem += step; rem >= hwl; rem -= hwl) ++tq;  // at most step / hwl + 1 rounds
    }
    for (int f = (n & ~3) + tid; f < n; f += blockDim.x) {
      const int tq = f / hwl;
      out[f] = value(tq, f - tq * hwl);
    }
  }
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

// maps, dmaps: num_levels device pointers each to (Q, h_l, w_l) f32; a null
// dmap is a level whose gradient is not wanted; the maps are read only when
// dcoords is not null. grad: the window gradient (B, L*(2r+1)^2, H, W) f32
// at element offset b*grad_sb + (y*W + x)*grad_sp + k*grad_sc. dcoords:
// (B, 2, H, W) f32 or null. Each non-null output is written whole (every
// dmap 16-byte aligned). Launches on `stream`; returns the launch's
// cudaError_t (0 on success).
extern "C" int lookup_grad_launch(const float* const* maps, float* const* dmaps,
                                  const int* heights, const int* widths, int num_levels,
                                  const float* coords, const float* grad, long long grad_sb,
                                  long long grad_sp, long long grad_sc, float* dcoords,
                                  long long num_queries, long long hw, int radius,
                                  void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || (radius != 3 && radius != 4) ||
      hw <= 0 || num_queries % hw != 0 || num_queries >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  GradLevels lv;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < num_levels;
    lv.map[l] = used ? maps[l] : nullptr;
    lv.dmap[l] = used ? dmaps[l] : nullptr;
    lv.h[l] = used ? heights[l] : 0;
    lv.w[l] = used ? widths[l] : 0;
    if (used && ((dcoords != nullptr && lv.map[l] == nullptr) ||
                 reinterpret_cast<uintptr_t>(lv.dmap[l]) % 16 != 0 ||
                 (long long)kGradQueries * lv.h[l] * lv.w[l] >= (1LL << 31))) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (num_queries == 0) {
    return (int)cudaSuccess;
  }
  const unsigned blocks = (unsigned)((num_queries + kGradQueries - 1) / kGradQueries);
  cudaStream_t s = (cudaStream_t)stream;
  if (radius == 3) {
    lookup_grad_kernel<3><<<blocks, 32 * kGradQueries, 0, s>>>(
        lv, coords, grad, grad_sb, grad_sp, grad_sc, dcoords, num_levels, (int)hw,
        (int)num_queries);
  } else {
    lookup_grad_kernel<4><<<blocks, 32 * kGradQueries, 0, s>>>(
        lv, coords, grad, grad_sb, grad_sp, grad_sc, dcoords, num_levels, (int)hw,
        (int)num_queries);
  }
  return (int)cudaGetLastError();
}
