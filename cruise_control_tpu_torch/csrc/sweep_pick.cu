// K6 sweep_pick: the window sibling plane of the global leadership sweep.
//
// Replaces the sibling-plane block of global_leadership_sweep's round body
// (cruise_control_tpu/analyzer/leadership.py, the [W, RF] planes from
// rows_w to the argmax).  For window member w (partition p = sel[w],
// current leader cur[w]) and sibling option j (replica r = rows[p, j],
// broker cb = replica_broker[max(r, 0)]):
//   ok     = r >= 0 && r != cur[w] && static_ok[r] && alive[cb]
//            && leader_ok[cb] && W[cb] + value[r] <= hard_cap[cb]
//            (&& value[r] < 2 * deficit in mean mode);
//   deficit = fill_to[cb] - W[cb];
//   score  = fma(0.1 * spread, (jit[p, j] + salt) mod 1, deficit)
//            (then fma(0.5 * spread, tb_norm[cb], score) with a
//            tiebreak);
//   spread = max(max |deficit| over the WHOLE [W, RF] plane, feasible or
//            not, 1e-6).
// Outputs the promoted replica max(rows[p, j*], 0) of the first-max
// feasible option j* (option 0 when none is feasible) and has = has_in[w]
// && any(ok).  Each score term's product and the sum after it are one
// FMA (__fmaf_rn), as XLA:CPU contracts them in the reference's compiled
// sweep; every other product and sum is rounded on its own; fmodf is
// exact.
//
// Bound: latency.  The window holds at most 4096 rows of RF = 3 options;
// each option is a short chain of dependent gathers (rows -> broker ->
// broker planes).  Two launches, because the spread is a max over the
// whole plane that every score needs: (1) a grid-stride max of |deficit|
// into one word (non-negative floats order like their bit patterns, so an
// integer atomicMax is exact and order-free); (2) a thread per window row
// scores its options.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  int Wn, RF;
  const int* sel;
  const uint8_t* has_in;
  const int* cur;
  const int* rows;
  const float* jit;
  const int* replica_broker;
  const float* value;
  const uint8_t* static_ok;
  const uint8_t* alive;
  const uint8_t* leader_ok;
  const float* load;
  const float* fill_to;
  const float* hard_cap;
  const float* tb_norm;  // null without a tiebreak
  float salt;
  int improve_gate;
  unsigned* max_abs;  // scratch word
  int* dst_r;
  uint8_t* has;
};

__device__ __forceinline__ int option_broker(const Args& a, int w, int j,
                                             int* r_out) {
  const int r = a.rows[(size_t)a.sel[w] * a.RF + j];
  *r_out = r;
  return a.replica_broker[r > 0 ? r : 0];
}

__global__ void spread_kernel(Args a) {
  const long long total = (long long)a.Wn * a.RF;
  float m = 0.f;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    int r;
    const int cb = option_broker(a, (int)(e / a.RF), (int)(e % a.RF), &r);
    m = fmaxf(m, fabsf(__fsub_rn(a.fill_to[cb], a.load[cb])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) atomicMax(a.max_abs, __float_as_uint(m));
}

__global__ void score_kernel(Args a) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= a.Wn) return;
  const float spread = fmaxf(__uint_as_float(*a.max_abs), 1e-6f);
  const float jit_amp = __fmul_rn(0.1f, spread);
  const float tb_amp = __fmul_rn(0.5f, spread);
  const int cur = a.cur[w];
  const size_t row0 = (size_t)a.sel[w] * a.RF;
  float best = -INFINITY;
  int bj = 0;
  bool any = false;
  for (int j = 0; j < a.RF; ++j) {
    int r;
    const int cb = option_broker(a, w, j, &r);
    const int rs = r > 0 ? r : 0;
    const float va = a.value[rs];
    const float deficit = __fsub_rn(a.fill_to[cb], a.load[cb]);
    bool ok = r >= 0 && r != cur && a.static_ok[rs] && a.alive[cb] &&
              a.leader_ok[cb] && __fadd_rn(a.load[cb], va) <= a.hard_cap[cb];
    if (a.improve_gate) ok = ok && va < __fmul_rn(2.0f, deficit);
    // (jit + salt) mod 1: the truncated remainder, shifted to be >= 0
    float frac = fmodf(__fadd_rn(a.jit[row0 + j], a.salt), 1.0f);
    if (frac != 0.f && frac < 0.f) frac = __fadd_rn(frac, 1.0f);
    // each product and the sum after it are one FMA, as the reference's
    // compiled sweep rounds them
    float sc = __fmaf_rn(jit_amp, frac, deficit);
    if (a.tb_norm != nullptr)
      sc = __fmaf_rn(tb_amp, a.tb_norm[cb], sc);
    sc = ok ? sc : -INFINITY;
    if (j == 0 || sc > best) {
      best = sc;
      bj = j;
    }
    any = any || ok;
  }
  const int r = a.rows[row0 + bj];
  a.dst_r[w] = r > 0 ? r : 0;
  a.has[w] = a.has_in[w] && any;
}

}  // namespace

extern "C" int cc_sweep_pick(
    int Wn, int RF, const int* sel, const uint8_t* has_in, const int* cur,
    const int* rows, const float* jit, const int* replica_broker,
    const float* value, const uint8_t* static_ok, const uint8_t* alive,
    const uint8_t* leader_ok, const float* load, const float* fill_to,
    const float* hard_cap, const float* tb_norm, float salt, int improve_gate,
    unsigned* max_abs, int* dst_r, uint8_t* has, void* stream) {
  if (Wn <= 0) return 0;
  Args a{Wn,       RF,      sel,       has_in,  cur,      rows,
         jit,      replica_broker,     value,   static_ok, alive,
         leader_ok, load,   fill_to,   hard_cap, tb_norm, salt,
         improve_gate,      max_abs,   dst_r,   has};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = (int)cudaMemsetAsync(max_abs, 0, sizeof(unsigned), st);
  if (err != 0) return err;
  const long long total = (long long)Wn * RF;
  int blocks = (int)((total + kThreads - 1) / kThreads);
  if (blocks > 1024) blocks = 1024;
  spread_kernel<<<blocks, kThreads, 0, st>>>(a);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  score_kernel<<<(Wn + kThreads - 1) / kThreads, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
