// The axis vote's sphere count (cppf_tpu_torch/ops/voting.py::
// rot_vote_sphere_count), hand-written for Hopper (sm_90a).  Plain C entry
// point, bound from Python with ctypes (cppf_tpu_torch/ops/vote_hist.py::
// sphere_count); it returns a cudaError_t.
//
// Replaces no TPU kernel: JAX leaves the count to XLA
// (cppf_tpu/ops/voting.py:869-929), and the port's plain version
// (voting.py::rot_vote_sphere_count_plain) makes it from [chunk * n_rots,
// S] float32 temporaries, a dozen passes over ~142 MB a 1 024-pair chunk.
//
// What it counts.  A pair of the subsample (voting.py::sphere_pair_params:
// co_unit, t = tan psi, y_unit, a degenerate flag, sign(t) ab_unit, a weight)
// casts n_rots candidate axes on a cone about ab: c_k = t (cos a_r co_k +
// sin a_r y_k) + sign(t) ab_k, u = c / (|c| + 1e-7), the zero axis for a
// degenerate pair.  Sphere direction s counts the candidates with (u_x s_x +
// u_y s_y) + u_z s_z > cos_tol.  Every step is rounded on its own
// (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn: nvcc contracts none of them
// into a fused multiply-add) in the plain version's order, and cos a_r, sin
// a_r come from the wrapper's table (torch.cos, torch.sin), so that each
// test gives the plain version's bit: the counts, whole numbers, are equal.
//
// Bound.  At the cells' shapes (10 000 pairs, 72 rotations, 480 directions)
// a vote is 345.6 M tests of 5 float operations: 1.73 G operations, 0.026 ms
// at 67 TFLOP/s; the inputs are 0.5 MB.  What holds the kernel is
// instruction issue: a test is 3 FMUL, 2 FADD (no FMA: it would change
// bits), a compare and a predicated add.
//
// Design.  The directions live in registers: a thread holds kDirs of them
// and a counter each (a block of ceil(S / kDirs) threads, rounded up to a
// warp, covers a slice of the sphere; padding directions are NaN, which no
// test passes).  A block takes a range of candidates, pair-major, kTile at a
// time: its threads make the tile's axes once into shared memory, then every
// thread tests each axis (one broadcast 16-byte load) against its own
// directions.  A hit adds to the thread's own counter, so the loop has no
// atomics, and a count does not depend on the order of the candidates.  At
// the end each non-zero counter goes to the output with one global integer
// atomicAdd, exact in any order.  The launch is as many blocks as are
// resident at once, or one a tile where the work needs fewer.
//
// Weights (voting.py's weights=, sharp_axis_votes).  A hit adds its pair's
// weight in int64 fixed point, llrint(w 2^shift); the wrapper picks the
// shift that puts max|w| 2^shift n_pairs n_rots in [2^60, 2^62), so that no
// sum overflows, and scales the sums by 2^-shift.  Integer sums do not depend
// on the order of the atomics: every run gives the same bits, within one
// rounding unit a hit of the float64 sum of the same hits.
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kDirs = 3;           // sphere directions a thread holds
constexpr int kMaxThreads = 1024;  // a block: ceil(S / kDirs) threads, rounded up to a warp
constexpr int kTile = 576;         // candidate axes a block makes and tests at a time (9 KB)

// Candidate axis r of the pair whose block is a | b | d, with its weight in
// .w; voting.py::rot_vote_sphere_count_plain's operations in its order.
__device__ __forceinline__ float4 cone_axis(float4 a, float4 b, float4 d, float ca, float sa) {
  // a = co_unit, t; b = y_unit, degenerate; d = sign(t) ab_unit, weight
  auto comp = [&](float co, float y, float sab) {
    return __fadd_rn(__fmul_rn(a.w, __fadd_rn(__fmul_rn(ca, co), __fmul_rn(sa, y))), sab);
  };
  const float c0 = comp(a.x, b.x, d.x), c1 = comp(a.y, b.y, d.y), c2 = comp(a.z, b.z, d.z);
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(c0, c0), __fmul_rn(c1, c1)), __fmul_rn(c2, c2));
  const float norm = __fadd_rn(__fsqrt_rn(sq), (float)1e-7);
  if (b.w != 0.f) return make_float4(0.f, 0.f, 0.f, d.w);
  return make_float4(__fdiv_rn(c0, norm), __fdiv_rn(c1, norm), __fdiv_rn(c2, norm), d.w);
}

// pairs: f32 [n_pairs, 12] as three float4 a pair; table: f32 [2, n_rots]
// (cos, sin); sphere: f32 [n_sphere, 3]; out: int32 [n_sphere] (kWeighted:
// int64), added to; shift: device int32, read when kWeighted.
template <bool kWeighted>
__global__ void __launch_bounds__(kMaxThreads) sphere_count_kernel(
    const float4* __restrict__ pairs, long long n_cand, int n_rots,
    const float* __restrict__ table, const float* __restrict__ sphere, int n_sphere,
    float cos_tol, const int* __restrict__ shift, long long per_block, void* out) {
  __shared__ float4 tile[kTile];
  using Acc = typename std::conditional<kWeighted, long long, int>::type;

  const float nan = __int_as_float(0x7fffffff);
  float sx[kDirs], sy[kDirs], sz[kDirs];
  Acc acc[kDirs];
  const int base = blockIdx.y * blockDim.x * kDirs + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kDirs; ++j) {
    const int s = base + j * blockDim.x;
    const bool in = s < n_sphere;
    sx[j] = in ? __ldg(sphere + 3 * s) : nan;
    sy[j] = in ? __ldg(sphere + 3 * s + 1) : nan;
    sz[j] = in ? __ldg(sphere + 3 * s + 2) : nan;
    acc[j] = 0;
  }
  const double scale = kWeighted ? ldexp(1.0, *shift) : 0.0;

  const long long lo = blockIdx.x * per_block;
  const long long hi = lo + per_block < n_cand ? lo + per_block : n_cand;
  for (long long t0 = lo; t0 < hi; t0 += kTile) {
    const int n = hi - t0 < kTile ? (int)(hi - t0) : kTile;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const long long c = t0 + i;
      const long long p = c / n_rots;
      const int r = (int)(c - p * n_rots);
      tile[i] = cone_axis(__ldg(pairs + 3 * p), __ldg(pairs + 3 * p + 1),
                          __ldg(pairs + 3 * p + 2), __ldg(table + r), __ldg(table + n_rots + r));
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float4 u = tile[i];
#pragma unroll
      for (int j = 0; j < kDirs; ++j) {
        const float dot = __fadd_rn(__fadd_rn(__fmul_rn(u.x, sx[j]), __fmul_rn(u.y, sy[j])),
                                    __fmul_rn(u.z, sz[j]));
        if (dot > cos_tol) {
          if constexpr (kWeighted) {
            acc[j] += __double2ll_rn((double)u.w * scale);
          } else {
            acc[j] += 1;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kDirs; ++j) {
    const int s = base + j * blockDim.x;
    if (s >= n_sphere || acc[j] == 0) continue;
    if constexpr (kWeighted) {
      atomicAdd(static_cast<unsigned long long*>(out) + s, (unsigned long long)acc[j]);
    } else {
      atomicAdd(static_cast<int*>(out) + s, acc[j]);
    }
  }
}

template <bool kWeighted>
cudaError_t launch(const float4* pairs, long long n_pairs, int n_rots, const float* table,
                   const float* sphere, int n_sphere, float cos_tol, const int* shift, void* out,
                   cudaStream_t stream) {
  auto kernel = sphere_count_kernel<kWeighted>;
  const int threads = std::min(kMaxThreads, ((n_sphere + kDirs - 1) / kDirs + 31) / 32 * 32);
  const int slices = (n_sphere + threads * kDirs - 1) / (threads * kDirs);
  const long long n_cand = n_pairs * n_rots;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  }
  if (e != cudaSuccess) return e;
  const long long resident = std::max(1LL, (long long)sms * per_sm / slices);
  const long long blocks = std::min(resident, (n_cand + kTile - 1) / kTile);
  const long long per_block = (n_cand + blocks - 1) / blocks;
  const dim3 grid((unsigned)((n_cand + per_block - 1) / per_block), (unsigned)slices);
  kernel<<<grid, threads, 0, stream>>>(pairs, n_cand, n_rots, table, sphere, n_sphere, cos_tol,
                                       shift, per_block, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pairs: f32 [n_pairs, 12] of voting.py::sphere_pair_params, 16-byte
// aligned; table: f32 [2, n_rots]; sphere: f32 [n_sphere, 3]; out: zeroed
// int32 [n_sphere], or int64 with a device int32 shift for the weighted sums.
int cppf_sphere_count(const void* pairs, long long n_pairs, int n_rots, const void* table,
                      const void* sphere, int n_sphere, float cos_tol, const void* shift,
                      void* out, void* stream) {
  if (n_pairs <= 0 || n_rots <= 0 || n_sphere <= 0) return (int)cudaSuccess;
  auto go = [&](auto launcher) {
    return (int)launcher((const float4*)pairs, n_pairs, n_rots, (const float*)table,
                         (const float*)sphere, n_sphere, cos_tol, (const int*)shift, out,
                         (cudaStream_t)stream);
  };
  return shift ? go(launch<true>) : go(launch<false>);
}

const char* cppf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
