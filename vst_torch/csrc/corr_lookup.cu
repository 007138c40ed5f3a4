// RAFT correlation-window lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel vst/kernels/pallas_corr.py:_kernel and
// pallas_lookup_level (called through _lookup_forward / pallas_lookup_pyramid).
// Computes what vst_torch.flow.corr.lookup_pyramid computes: for every query q
// and pyramid level l, (2r+1)^2 bilinear samples, with zero padding, of q's own
// (h_l, w_l) correlation map at coords[q] / 2^l + (a - r, b - r), where the X
// offset a varies along the FIRST window axis (channel k = a*(2r+1) + b).
//
// Design. The Pallas kernel ran each query's window as a row-mask x map matmul
// on the TPU's matrix unit, with bf16 interpolation multiplies. Here it is a
// plain gather: one thread per output element (q, l, k), reading the <= 4
// neighbours it needs, each with its own bounds test, and interpolating in
// f32 with the same operation order as the plain version (no FMA contraction,
// so the two agree bit for bit). Threads are numbered in the output's
// channel-last order (q, l, k), so the writes of a warp are contiguous and the
// reads of a warp fall in one query's 10x10 patch. All levels run in one
// launch, writing straight into the (B, H, W, L*(2r+1)^2) layout.
//
// Bound: memory. Per launch it writes Q*L*(2r+1)^2*4 bytes and reads at most
// Q*L*(2r+2)^2*4 bytes of the maps plus Q*8 bytes of coords. At the Sintel
// tcl2 shape (B=4, 54x128 -> Q=27648, L=4, r=4): 35.8 MB written, <= 44.2 MB
// read, ~80 MB a launch, ~24 us at 3.35 TB/s. It does ~17 f32 operations per
// output, far below the card's f32 rate.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;

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

__global__ void corr_lookup_kernel(Pyramid pyr, const float* __restrict__ coords,
                                   float* __restrict__ out, int num_levels,
                                   long long hw, int radius, long long total) {
  const int n = 2 * radius + 1;
  const int n2 = n * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int k = (int)(idx % n2);
    const long long ql = idx / n2;
    const int l = (int)(ql % num_levels);
    const long long q = ql / num_levels;
    const long long b = q / hw;
    const float* c = coords + b * 2 * hw + (q - b * hw);  // (B, 2, H, W)
    const float inv = 1.f / (float)(1 << l);              // exact power of 2
    const float x = __fadd_rn(__fmul_rn(__ldg(c), inv), (float)(k / n - radius));
    const float y = __fadd_rn(__fmul_rn(__ldg(c + hw), inv), (float)(k % n - radius));
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float wx1 = __fsub_rn(x, x0);
    const float wy1 = __fsub_rn(y, y0);
    const float wx0 = __fsub_rn(1.f, wx1);
    const float wy0 = __fsub_rn(1.f, wy1);
    const int h = pyr.h[l];
    const int w = pyr.w[l];
    const float* map = pyr.level[l] + q * (long long)h * w;
    float s = tap(map, h, w, x0, y0, __fmul_rn(wy0, wx0));
    s = __fadd_rn(s, tap(map, h, w, x0 + 1.f, y0, __fmul_rn(wy0, wx1)));
    s = __fadd_rn(s, tap(map, h, w, x0, y0 + 1.f, __fmul_rn(wy1, wx0)));
    s = __fadd_rn(s, tap(map, h, w, x0 + 1.f, y0 + 1.f, __fmul_rn(wy1, wx1)));
    out[idx] = s;
  }
}

}  // namespace

// levels: num_levels device pointers to (Q, h_l, w_l) f32 maps, the rest null.
// coords: (B, 2, H, W) f32 with Q = B*H*W and hw = H*W.
// out: (Q, num_levels*(2r+1)^2) f32. Launches on `stream`; returns the
// launch's cudaError_t (0 on success).
extern "C" int corr_lookup_launch(const float* level0, const float* level1,
                                  const float* level2, const float* level3,
                                  const int* heights, const int* widths,
                                  int num_levels, const float* coords, float* out,
                                  long long num_queries, long long hw, int radius,
                                  void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 0 || hw <= 0 ||
      num_queries % hw != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Pyramid pyr;
  const float* levels[kMaxLevels] = {level0, level1, level2, level3};
  for (int l = 0; l < kMaxLevels; ++l) {
    pyr.level[l] = levels[l];
    pyr.h[l] = l < num_levels ? heights[l] : 0;
    pyr.w[l] = l < num_levels ? widths[l] : 0;
  }
  const long long n = 2LL * radius + 1;
  const long long total = num_queries * num_levels * n * n;
  if (total == 0) {
    return (int)cudaSuccess;
  }
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65536) {
    blocks = 65536;  // the grid-stride loop covers the rest
  }
  corr_lookup_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      pyr, coords, out, num_levels, hw, radius, total);
  return (int)cudaGetLastError();
}
