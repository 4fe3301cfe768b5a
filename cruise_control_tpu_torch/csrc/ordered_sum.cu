// K13 ordered_sum: float32 column sums of x[n, m] in XLA:CPU's order.
//
// Replaces the float `jnp.sum(..., axis=0)` of the reference's compiled
// programs: compute_stats (cruise_control_tpu/model/stats.py :67-75,
// :137-145), cluster_load / cluster_capacity (model/state.py :409-418),
// the leadership bounds (analyzer/leadership.py :418), the count goals'
// averages and rotation_salt's float mix.  XLA:CPU reduces a long axis in
// windows: while more than 32 terms remain, they are zero-padded to a
// multiple of 32, (m*32 - n)//2 zeros before the data and the rest after,
// and each window of 32 is added sequentially from +0.0; the last <= 32
// terms are added sequentially from +0.0, except a single term, which XLA
// copies (a -0.0 stays -0.0).  The plain version is ops.sum_f32_plain.
//
// Design: one launch, a block per column of up to 1,024 threads.  Its
// threads take the windows of a level, each adding its 32 terms with fadd_rn, write the window sums to
// the column's scratch and meet at a barrier; the next level reads them;
// thread 0 adds the last <= 32 terms.  Bound: memory (each input read once,
// each output written once); a column of n terms takes about log32(n)
// dependent levels of 32 adds.  A long plane is bound by its blocks' SMs:
// at [600,000, 4] each of the four blocks pulls every sector of the
// interleaved columns through one SM.

#include <cuda_runtime.h>

namespace {

__global__ void ordered_sum_kernel(const float* __restrict__ x, int n, int m,
                                   float* __restrict__ scratch,
                                   long long scratch_per_col,
                                   float* __restrict__ out) {
  const int col = blockIdx.x;
  float* sc = scratch + scratch_per_col * col;
  const float* src = x + col;
  long long stride = m;
  int len = n;
  while (len > 32) {
    const int w = (len + 31) / 32;
    const int lo = (w * 32 - len) / 2;
    for (int i = threadIdx.x; i < w; i += blockDim.x) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = i * 32 + j - lo;
        const float v = (r >= 0 && r < len) ? src[r * stride] : 0.f;
        acc = __fadd_rn(acc, v);
      }
      sc[i] = acc;
    }
    __syncthreads();
    src = sc;
    stride = 1;
    sc += w;
    len = w;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int j = 0; j < len; ++j) acc = __fadd_rn(acc, src[j * stride]);
    out[col] = len == 1 ? src[0] : acc;
  }
}

}  // namespace

// x f32[n, m] row-major, out f32[m]; scratch f32[m * scratch_per_col], where
// scratch_per_col is the sum of the window counts of every level with more
// than 32 terms (0 when n <= 32).
extern "C" int cc_ordered_sum(const float* x, int n, int m, float* scratch,
                              long long scratch_per_col, float* out,
                              void* stream) {
  if (m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int windows = (n + 31) / 32;
  int threads = ((windows + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  ordered_sum_kernel<<<m, threads, 0, st>>>(x, n, m, scratch, scratch_per_col,
                                            out);
  return (int)cudaGetLastError();
}
