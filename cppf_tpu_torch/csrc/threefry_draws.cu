// JAX's default random numbers (cppf_tpu_torch/core/threefry.py::draw_many)
// for CUDA tensors, hand-written for Hopper (sm_90a).  Plain C entry point,
// bound from Python with ctypes (core/threefry.py::_draw_many_cuda); it
// returns a cudaError_t.
//
// Replaces no TPU kernel: JAX leaves the hash to XLA's threefry2x32, and the
// port's plain version (threefry.py::draw_many_plain) hashes every counter
// in int64 tensors, ~170 elementwise passes over ~107-214 MB a pose.
//
// What it computes.  A launch takes a table of up to kMaxRequests requests
// by value, in the launch's parameters (no upload, no host sync).  Request
// r owns the elements [start[r], start[r + 1]) of one flat float32 output;
// its element i is threefry2x32 (20 rounds) of the counter words
// (c >> 32, c & 0xffffffff), c = i - start[r], under the request's key, the
// two words xored, then the uniform float on [lo, hi) of the top 23 bits
// (jax.random.uniform), then the request's kind: the uniform itself
// (uniform, bernoulli: the wrapper compares with 1/2), -log(-log(u))
// (gumbel, u on [tiny, 1)), or sqrt(2) * erfinv(u) with XLA's float32
// polynomial for erfinv (normal, u on (nextafter(-1, 0), 1)).  Every float
// step rounds where the plain version's PyTorch kernels round, one operation
// at a time (__fmul_rn, __fadd_rn, __fsub_rn, __fsqrt_rn: nvcc contracts
// none of them into a fused multiply-add), and the transcendentals are the
// libdevice logf and log1pf that PyTorch's CUDA log and log1p call (no fast
// math): each element equals the plain version's on the same card, to the
// bit.
//
// Bound.  A bottle pose draws 13.40 M elements (a table pose 13.77 M): 53.6
// MB of float32 written, 0.016 ms at 3.35 TB/s; ~77 integer operations a
// hash, ~6 for the uniform, ~50 for a Gumbel's two logf: ~1.8 G operations,
// 0.027 ms at 67 TFLOP/s and ~0.06 ms at Hopper's int32 rate.  So the bound
// is instruction issue, and the design's answer is that no intermediate
// leaves registers: each thread finds its element's request by a binary
// search of the table's starts (uniform across a warp but at a request's
// edge), hashes, transforms and writes the float once; neighbouring threads
// write neighbouring floats.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRequests = 64;  // rows of a launch's table (threefry.py MAX_REQUESTS)
constexpr int kThreads = 256;
constexpr int kPerThread = 8;  // elements a thread, kThreads apart
constexpr long long kTile = (long long)kThreads * kPerThread;

enum Kind : int { kUniform = 0, kGumbel = 1, kNormal = 2 };

// 1 804 bytes, within the 4 KB of a launch's parameters
struct Table {
  long long start[kMaxRequests + 1];
  unsigned key[kMaxRequests][2];
  float lo[kMaxRequests];
  float hi[kMaxRequests];
  int kind[kMaxRequests];
  int n;
};

template <int A, int B, int C, int D>
__device__ __forceinline__ void four_rounds(unsigned& x0, unsigned& x1) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, A) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, B) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, C) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, D) ^ x0;
}

// threefry2x32 of the counter (c0, c1) under key (k0, k1), its two words
// xored; threefry.py::threefry2x32's key schedule and rotations
__device__ __forceinline__ unsigned threefry_bits(unsigned k0, unsigned k1, unsigned c0,
                                                  unsigned c1) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  unsigned x0 = c0 + k0, x1 = c1 + k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

// threefry.py::_uniform: max(lo, f * (hi - lo) + lo), f in [0, 1)
__device__ __forceinline__ float uniform(unsigned bits, float lo, float hi) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fadd_rn(__fmul_rn(f, __fsub_rn(hi, lo)), lo));
}

// threefry.py::erfinv: XLA's float32 ErfInv, each step rounded on its own;
// the coefficients are the Python floats rounded to float32, as torch does
__device__ __forceinline__ float erfinv_xla(float x) {
  const float lt5[9] = {
      static_cast<float>(2.81022636e-08), static_cast<float>(3.43273939e-07),
      static_cast<float>(-3.5233877e-06), static_cast<float>(-4.39150654e-06),
      static_cast<float>(0.00021858087), static_cast<float>(-0.00125372503),
      static_cast<float>(-0.00417768164), static_cast<float>(0.246640727),
      static_cast<float>(1.50140941)};
  const float ge5[9] = {
      static_cast<float>(-0.000200214257), static_cast<float>(0.000100950558),
      static_cast<float>(0.00134934322), static_cast<float>(-0.00367342844),
      static_cast<float>(0.00573950773), static_cast<float>(-0.0076224613),
      static_cast<float>(0.00943887047), static_cast<float>(1.00167406),
      static_cast<float>(2.83297682)};
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int j = 1; j < 9; ++j) p = __fadd_rn(lt ? lt5[j] : ge5[j], __fmul_rn(p, w));
  return __fmul_rn(p, x);
}

__global__ void __launch_bounds__(kThreads)
    threefry_draws_kernel(const __grid_constant__ Table t, float* __restrict__ out) {
  const float sqrt2 = static_cast<float>(1.4142135623730951);
  const long long total = t.start[t.n];
  long long i = blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k, i += kThreads) {
    if (i >= total) return;
    int r = 0, end = t.n;  // the last request whose start is <= i
    while (end - r > 1) {
      const int mid = (r + end) >> 1;
      if (t.start[mid] <= i) {
        r = mid;
      } else {
        end = mid;
      }
    }
    const unsigned long long c = (unsigned long long)(i - t.start[r]);
    const float u = uniform(threefry_bits(t.key[r][0], t.key[r][1], (unsigned)(c >> 32),
                                          (unsigned)c),
                            t.lo[r], t.hi[r]);
    const int kind = t.kind[r];
    out[i] = kind == kGumbel ? -logf(-logf(u))
             : kind == kNormal ? __fmul_rn(sqrt2, erfinv_xla(u))
                               : u;
  }
}

}  // namespace

extern "C" {

// n requests (1 <= n <= kMaxRequests), in the order of the output: starts
// int64 [n + 1] (starts[0] = 0), keys uint32 [n, 2], kinds int32 [n] (0
// uniform, 1 gumbel, 2 normal), lo / hi float32 [n], all host memory, read
// before the call returns; out: float32 [starts[n]] on the device.
int cppf_threefry_draws(int n, const long long* starts, const unsigned* keys, const int* kinds,
                        const float* lo, const float* hi, void* out, void* stream) {
  if (n < 1 || n > kMaxRequests || starts[0] != 0) return (int)cudaErrorInvalidValue;
  Table t = {};
  t.n = n;
  for (int r = 0; r < n; ++r) {
    if (starts[r + 1] < starts[r] || kinds[r] < kUniform || kinds[r] > kNormal) {
      return (int)cudaErrorInvalidValue;
    }
    t.start[r] = starts[r];
    t.key[r][0] = keys[2 * r];
    t.key[r][1] = keys[2 * r + 1];
    t.kind[r] = kinds[r];
    t.lo[r] = lo[r];
    t.hi[r] = hi[r];
  }
  t.start[n] = starts[n];
  if (starts[n] == 0) return (int)cudaSuccess;
  const long long blocks = (starts[n] + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  threefry_draws_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      t, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* cppf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
