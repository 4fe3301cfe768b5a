// K14 cumsum_blocks: inclusive float32 scan along the rows of x[rows, n] in
// XLA:CPU's order.
//
// Replaces the float `jnp.cumsum(..., axis=1)` prefix gates of the
// reference's round bodies (cruise_control_tpu/analyzer/kernels.py :429,
// :436, :1052, :1058; analyzer/prebalance.py :167-175).  XLA:CPU copies a
// row of one; it scans a row of 2 <= n <= 16 sequentially from +0.0 (so a
// leading -0.0 becomes +0.0), and a longer row in blocks of 16: each block
// scanned so, the block totals scanned the same way (recursively), and
// each block's carry (+0.0 for the first block) added to its sums.  The
// plain version is ops.cumsum_f32_plain.
//
// Design: n <= 16 (every main-path call, [B, k] with k <= 16): one thread
// per row.  Longer rows: a block per row; its threads scan the 16-blocks of
// the row into the output and the totals into shared memory, level by
// level, thread 0 scans the top level (<= 16 terms), and the carries are
// added back down.  Every add is fadd_rn.  Bound: memory (each input read
// once, each output written once).

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 16;
constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

__global__ void scan_short_kernel(const float* __restrict__ x, int rows,
                                  int n, float* __restrict__ out) {
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       r < rows; r += (long long)gridDim.x * blockDim.x) {
    const float* xr = x + r * n;
    float* o = out + r * n;
    float s = n > 1 ? __fadd_rn(0.f, xr[0]) : xr[0];
    o[0] = s;
    for (int j = 1; j < n; ++j) {
      s = __fadd_rn(s, xr[j]);
      o[j] = s;
    }
  }
}

// Scan each group of 16 of src[0, len) into dst sequentially from +0.0; the
// group's last sum to tot[g].
__device__ void scan_groups(const float* src, float* dst, int len,
                            float* tot) {
  const int groups = (len + kGroup - 1) / kGroup;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int base = g * kGroup;
    const int end = min(base + kGroup, len);
    float s = __fadd_rn(0.f, src[base]);
    dst[base] = s;
    for (int j = base + 1; j < end; ++j) {
      s = __fadd_rn(s, src[j]);
      dst[j] = s;
    }
    tot[g] = s;
  }
}

// a[j] += the scanned total of the groups before j's (+0.0 for group 0).
__device__ void add_carry(float* a, int len, const float* scanned) {
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const int g = j / kGroup;
    a[j] = __fadd_rn(a[j], g ? scanned[g - 1] : 0.f);
  }
}

__global__ void scan_long_kernel(const float* __restrict__ x, int n,
                                 float* __restrict__ out) {
  extern __shared__ float lv[];  // the levels above the row
  const float* xr = x + (long long)blockIdx.x * n;
  float* o = out + (long long)blockIdx.x * n;
  int len[kMaxLevels];
  int off[kMaxLevels];
  int k = 0;
  int used = 0;
  len[0] = n;
  off[0] = 0;
  while (len[k] > kGroup) {
    len[k + 1] = (len[k] + kGroup - 1) / kGroup;
    off[k + 1] = used;
    used += len[k + 1];
    ++k;
  }
  scan_groups(xr, o, n, lv + off[1]);
  __syncthreads();
  for (int l = 1; l < k; ++l) {
    scan_groups(lv + off[l], lv + off[l], len[l], lv + off[l + 1]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float* t = lv + off[k];
    float s = __fadd_rn(0.f, t[0]);
    for (int j = 1; j < len[k]; ++j) {
      s = __fadd_rn(s, t[j]);
      t[j] = s;
    }
  }
  __syncthreads();
  for (int l = k - 1; l >= 1; --l) {
    add_carry(lv + off[l], len[l], lv + off[l + 1]);
    __syncthreads();
  }
  add_carry(o, n, lv + off[1]);
}

}  // namespace

// x, out f32[rows, n] row-major; n at most 131,072 (the levels above the
// row live in shared memory).
extern "C" int cc_cumsum_blocks(const float* x, int rows, int n, float* out,
                                void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (n > 131072) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kGroup) {
    long long blocks = (rows + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    scan_short_kernel<<<(int)blocks, kThreads, 0, st>>>(x, rows, n, out);
  } else {
    int used = 0;
    for (int len = n; len > kGroup;) {
      len = (len + kGroup - 1) / kGroup;
      used += len;
    }
    scan_long_kernel<<<rows, kThreads, sizeof(float) * used, st>>>(x, n,
                                                                   out);
  }
  return (int)cudaGetLastError();
}
