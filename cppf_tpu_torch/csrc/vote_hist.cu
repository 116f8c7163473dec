// Center-vote accumulation kernels for the branch-and-bound peak
// (cppf_tpu_torch/ops/voting.py::ppf_vote_peak) and the dense vote
// histogram (ppf_vote_dense), hand-written for Hopper (sm_90a).  Plain C
// entry points, bound from Python with ctypes
// (cppf_tpu_torch/ops/vote_hist.py); each returns cudaGetLastError().
//
// Replaces the TPU kernels of cppf_tpu/ops/pallas/vote_hist.py:
//   bound_projections  <- _bound_kernel  (:64-99,  pl.pallas_call at :126)
//   refine_window      <- _refine_kernel (:143-178, pl.pallas_call at :200)
//   dense_hist         <- _dense_kernel  (:208-251, pl.pallas_call at :310)
//
// Input: flat [V] vote vectors from _vote_coords — floors fx, fy, fz (int32,
// clipped to [0, g-2]), fractions rx, ry, rz (f32), weight w (f32; 0 marks a
// masked vote).  The splat is separable, hat_x (x) hat_y (x) hat_z, with two
// taps an axis (trilinear) or one (nearest).
//
// Bound of the two peak kernels on an H100 SXM (3.35 TB/s; dense_hist has
// its own note below): each must read the seven vote
// vectors once, 7 x 4 B x V = 202 MB at the bowl workload's V = 7.2 M, so
// >= 60 us each; the outputs (48 KB, 16 KB) are noise.  The work per vote is
// a handful of shared-memory atomics, far below the operation bound.
//
// Design.  The TPU kernels contract one-hot splat matrices on the MXU; on
// Hopper the natural form is a scatter.  Each block keeps its private copy
// of the output in shared memory, walks a grid-strided range of votes with
// coalesced loads, splats with shared-memory atomics (no global traffic per
// vote), and flushes its non-zero cells to global memory with one atomicAdd
// each.  Masked votes (w == 0) leave right after the weight load.  The
// refine window rejects a vote from its x floor alone when the vote cannot
// reach the window, so most votes cost two loads.  Any V is accepted: the
// tail is masked by the loop bound.  Atomics make the float sums
// order-dependent, so results agree with the plain PyTorch version to
// rounding, not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Shared layout: Mxy [gx, by_n] | Mxz [gx, bz_n] | Myz [gy, bz_n].  Rows are
// fine x (or y) taps weighted by w; columns are the unweighted y (or z) taps
// pooled by pfy (or pfz).
template <bool kNearest>
__global__ void __launch_bounds__(kThreads) bound_kernel(
    const int* __restrict__ fx, const int* __restrict__ fy, const int* __restrict__ fz,
    const float* __restrict__ rx, const float* __restrict__ ry, const float* __restrict__ rz,
    const float* __restrict__ w, long long n_votes, int gx, int gy, int by_n, int bz_n,
    int pfy, int pfz, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int n_xy = gx * by_n;
  const int n_xz = gx * bz_n;
  const int n_all = n_xy + n_xz + gy * bz_n;
  float* sxy = smem;
  float* sxz = smem + n_xy;
  float* syz = smem + n_xy + n_xz;
  for (int i = threadIdx.x; i < n_all; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n_votes;
       v += stride) {
    const float wv = w[v];
    if (wv == 0.f) continue;
    const int x = fx[v], y = fy[v], z = fz[v];
    const float ax = rx[v], ay = ry[v], az = rz[v];
    if (kNearest) {
      const int nx = ax > 0.5f ? x + 1 : x;
      const int ny = ay > 0.5f ? y + 1 : y;
      const int nz = az > 0.5f ? z + 1 : z;
      atomicAdd(&sxy[nx * by_n + ny / pfy], wv);
      atomicAdd(&sxz[nx * bz_n + nz / pfz], wv);
      atomicAdd(&syz[ny * bz_n + nz / pfz], wv);
    } else {
      const float hx0 = (1.f - ax) * wv, hx1 = ax * wv;
      const float hy0 = 1.f - ay, hy1 = ay;
      const float hz0 = 1.f - az, hz1 = az;
      const int cy0 = y / pfy, cy1 = (y + 1) / pfy;
      const int cz0 = z / pfz, cz1 = (z + 1) / pfz;
      float* xy0 = sxy + x * by_n;
      float* xy1 = xy0 + by_n;
      atomicAdd(xy0 + cy0, hx0 * hy0);
      atomicAdd(xy0 + cy1, hx0 * hy1);
      atomicAdd(xy1 + cy0, hx1 * hy0);
      atomicAdd(xy1 + cy1, hx1 * hy1);
      float* xz0 = sxz + x * bz_n;
      float* xz1 = xz0 + bz_n;
      atomicAdd(xz0 + cz0, hx0 * hz0);
      atomicAdd(xz0 + cz1, hx0 * hz1);
      atomicAdd(xz1 + cz0, hx1 * hz0);
      atomicAdd(xz1 + cz1, hx1 * hz1);
      const float wy0 = hy0 * wv, wy1 = hy1 * wv;
      float* yz0 = syz + y * bz_n;
      float* yz1 = yz0 + bz_n;
      atomicAdd(yz0 + cz0, wy0 * hz0);
      atomicAdd(yz0 + cz1, wy0 * hz1);
      atomicAdd(yz1 + cz0, wy1 * hz0);
      atomicAdd(yz1 + cz1, wy1 * hz1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_all; i += blockDim.x) {
    const float s = smem[i];
    if (s != 0.f) atomicAdd(out + i, s);
  }
}

// Exact fine splat mass in the w8^3 window at origin o (device int32[3],
// read here: no host sync).  Output [w8, w8*w8], x rows, (y, z) y-major.
template <bool kNearest>
__global__ void __launch_bounds__(kThreads) refine_kernel(
    const int* __restrict__ o, const int* __restrict__ fx, const int* __restrict__ fy,
    const int* __restrict__ fz, const float* __restrict__ rx, const float* __restrict__ ry,
    const float* __restrict__ rz, const float* __restrict__ w, long long n_votes, int w8,
    float* __restrict__ out) {
  extern __shared__ float win[];
  const int n_all = w8 * w8 * w8;
  for (int i = threadIdx.x; i < n_all; i += blockDim.x) win[i] = 0.f;
  const int ox = o[0], oy = o[1], oz = o[2];
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n_votes;
       v += stride) {
    // a floor at o-1 still reaches the window with its +1 tap
    const int lx = fx[v] - ox;
    if (lx < -1 || lx >= w8) continue;
    const float wv = w[v];
    if (wv == 0.f) continue;
    const int ly = fy[v] - oy;
    const int lz = fz[v] - oz;
    if (ly < -1 || ly >= w8 || lz < -1 || lz >= w8) continue;
    const float ax = rx[v], ay = ry[v], az = rz[v];
    if (kNearest) {
      const int nx = ax > 0.5f ? lx + 1 : lx;
      const int ny = ay > 0.5f ? ly + 1 : ly;
      const int nz = az > 0.5f ? lz + 1 : lz;
      if (nx >= 0 && nx < w8 && ny >= 0 && ny < w8 && nz >= 0 && nz < w8)
        atomicAdd(&win[(nx * w8 + ny) * w8 + nz], wv);
    } else {
      const float hx[2] = {(1.f - ax) * wv, ax * wv};
      const float hy[2] = {1.f - ay, ay};
      const float hz[2] = {1.f - az, az};
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int X = lx + dx;
        if (X < 0 || X >= w8) continue;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int Y = ly + dy;
          if (Y < 0 || Y >= w8) continue;
#pragma unroll
          for (int dz = 0; dz < 2; ++dz) {
            const int Z = lz + dz;
            if (Z < 0 || Z >= w8) continue;
            atomicAdd(&win[(X * w8 + Y) * w8 + Z], hx[dx] * (hy[dy] * hz[dz]));
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_all; i += blockDim.x) {
    const float s = win[i];
    if (s != 0.f) atomicAdd(out + i, s);
  }
}

// ---------------------------------------------------------------------------
// dense_hist: the dense vote histogram [cx, cy, cz], axis k pooled by p_k.
//
// Bound on an H100 SXM (3.35 TB/s): the weight of every vote and the other
// six vectors of every live vote are read once (up to 28 B a vote: 2.1 GB
// for the zero-shot frame's 2^20-pair chunk of 75 M votes, >= 0.63 ms), the
// grid written once (48 MB at 320x224x168).  The arithmetic is ~30 flops a
// vote, far below the operation bound.  What the bytes bound hides is the
// scatter: up to 8 atomic adds a vote, so the kernel is bound in practice
// by the atomic throughput of L2 (global grids) or shared memory.
//
// Design.  The TPU kernel contracts an x one-hot [cx, C] with a (y, z)
// one-hot [cy*cz, C] on the MXU per chunk of C votes, at O(V * cy * cz)
// compares, which caps its (y, z) plane (65 536 cells, a VMEM limit).  On
// Hopper the natural form is a scatter at O(V) cost, with no such cap:
//   * a grid that fits one block's shared memory (4*cells <= the opt-in
//     limit, 227 KB: the pooled coarse grid of the sparse route, 123 KB) is
//     kept as a private copy per block, splatted with shared atomics over a
//     grid-strided range of votes and flushed with one global atomicAdd per
//     non-zero cell, as bound_kernel does;
//   * a larger grid (the whole frame, 48 MB, which the 50 MB L2 holds; a
//     48^3 window, 442 KB) takes one thread per vote and a global atomicAdd
//     per pooled tap.
// Each axis has its taps (f, 1-r) and (f+1, r), pooled to cells f/p and
// (f+1)/p; when both land in one cell they merge into one tap of weight
// (1-r)+r, so a pool-8 vote costs ~1.4 atomics instead of 8.  Nearest
// splats one tap f+(r>0.5).  Masked votes (w == 0) leave after the weight
// load.  The limit is the device's memory: cell indices are 64-bit, and
// the caller guarantees (f+1)/p < c on every axis (floors clipped to g-2,
// c = ceil(g/p)).
constexpr int kDenseThreads = 1024;

template <bool kNearest>
__device__ __forceinline__ int axis_taps(int f, float r, int p, int* c, float* h) {
  if (kNearest) {
    c[0] = (r > 0.5f ? f + 1 : f) / p;
    h[0] = 1.f;
    return 1;
  }
  c[0] = f / p;
  c[1] = (f + 1) / p;
  h[0] = 1.f - r;
  h[1] = r;
  if (c[1] == c[0]) {
    h[0] += h[1];
    return 1;
  }
  return 2;
}

// Adds the pooled taps of vote v to hist (global or shared).
template <bool kNearest>
__device__ __forceinline__ void splat_dense(
    long long v, float wv, const int* __restrict__ fx, const int* __restrict__ fy,
    const int* __restrict__ fz, const float* __restrict__ rx, const float* __restrict__ ry,
    const float* __restrict__ rz, int cy, int cz, int px, int py, int pz, float* hist) {
  int ix[2], iy[2], iz[2];
  float hx[2], hy[2], hz[2];
  const int nx = axis_taps<kNearest>(fx[v], rx[v], px, ix, hx);
  const int ny = axis_taps<kNearest>(fy[v], ry[v], py, iy, hy);
  const int nz = axis_taps<kNearest>(fz[v], rz[v], pz, iz, hz);
  for (int a = 0; a < nx; ++a) {
    const float wx = hx[a] * wv;
    const long long row = (long long)ix[a] * cy;
    for (int b = 0; b < ny; ++b) {
      const float wxy = wx * hy[b];
      float* line = hist + (row + iy[b]) * cz;
      for (int c = 0; c < nz; ++c) atomicAdd(line + iz[c], wxy * hz[c]);
    }
  }
}

template <bool kNearest>
__global__ void __launch_bounds__(kThreads) dense_global_kernel(
    const int* __restrict__ fx, const int* __restrict__ fy, const int* __restrict__ fz,
    const float* __restrict__ rx, const float* __restrict__ ry, const float* __restrict__ rz,
    const float* __restrict__ w, long long n_votes, int cy, int cz, int px, int py, int pz,
    float* __restrict__ out) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_votes) return;
  const float wv = w[v];
  if (wv == 0.f) return;
  splat_dense<kNearest>(v, wv, fx, fy, fz, rx, ry, rz, cy, cz, px, py, pz, out);
}

template <bool kNearest>
__global__ void __launch_bounds__(kDenseThreads) dense_shared_kernel(
    const int* __restrict__ fx, const int* __restrict__ fy, const int* __restrict__ fz,
    const float* __restrict__ rx, const float* __restrict__ ry, const float* __restrict__ rz,
    const float* __restrict__ w, long long n_votes, int n_cells, int cy, int cz, int px,
    int py, int pz, float* __restrict__ out) {
  extern __shared__ float hist[];
  for (int i = threadIdx.x; i < n_cells; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n_votes;
       v += stride) {
    const float wv = w[v];
    if (wv == 0.f) continue;
    splat_dense<kNearest>(v, wv, fx, fy, fz, rx, ry, rz, cy, cz, px, py, pz, hist);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_cells; i += blockDim.x) {
    const float s = hist[i];
    if (s != 0.f) atomicAdd(out + i, s);
  }
}

// Enough blocks to fill every SM at the occupancy the shared memory allows,
// and no more than the votes need.
template <typename Kernel>
cudaError_t grid_size(Kernel kernel, size_t smem, long long n_votes, int* blocks,
                      int threads = kThreads) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  const long long need = (n_votes + threads - 1) / threads;
  const long long fill = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(need < fill ? need : fill);
  return cudaSuccess;
}

template <bool kNearest>
cudaError_t launch_dense(const int* fx, const int* fy, const int* fz, const float* rx,
                         const float* ry, const float* rz, const float* w, long long n_votes,
                         int cx, int cy, int cz, int px, int py, int pz, float* out,
                         cudaStream_t stream) {
  const long long n_cells = (long long)cx * cy * cz;
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (n_cells * (long long)sizeof(float) <= smem_max) {
    const size_t smem = sizeof(float) * (size_t)n_cells;
    int blocks = 0;
    e = grid_size(dense_shared_kernel<kNearest>, smem, n_votes, &blocks, kDenseThreads);
    if (e != cudaSuccess) return e;
    dense_shared_kernel<kNearest><<<blocks, kDenseThreads, smem, stream>>>(
        fx, fy, fz, rx, ry, rz, w, n_votes, (int)n_cells, cy, cz, px, py, pz, out);
  } else {
    const long long blocks = (n_votes + kThreads - 1) / kThreads;
    dense_global_kernel<kNearest><<<(unsigned)blocks, kThreads, 0, stream>>>(
        fx, fy, fz, rx, ry, rz, w, n_votes, cy, cz, px, py, pz, out);
  }
  return cudaGetLastError();
}

template <bool kNearest>
cudaError_t launch_bound(const int* fx, const int* fy, const int* fz, const float* rx,
                         const float* ry, const float* rz, const float* w, long long n_votes,
                         int gx, int gy, int by_n, int bz_n, int pfy, int pfz, float* out,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)gx * by_n + (size_t)gx * bz_n + (size_t)gy * bz_n);
  int blocks = 0;
  cudaError_t e = grid_size(bound_kernel<kNearest>, smem, n_votes, &blocks);
  if (e != cudaSuccess) return e;
  bound_kernel<kNearest><<<blocks, kThreads, smem, stream>>>(
      fx, fy, fz, rx, ry, rz, w, n_votes, gx, gy, by_n, bz_n, pfy, pfz, out);
  return cudaGetLastError();
}

template <bool kNearest>
cudaError_t launch_refine(const int* o, const int* fx, const int* fy, const int* fz,
                          const float* rx, const float* ry, const float* rz, const float* w,
                          long long n_votes, int w8, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)w8 * w8 * w8;
  int blocks = 0;
  cudaError_t e = grid_size(refine_kernel<kNearest>, smem, n_votes, &blocks);
  if (e != cudaSuccess) return e;
  refine_kernel<kNearest><<<blocks, kThreads, smem, stream>>>(
      o, fx, fy, fz, rx, ry, rz, w, n_votes, w8, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out: zeroed f32 [gx*by_n + gx*bz_n + gy*bz_n] = Mxy | Mxz | Myz.
int cppf_bound_projections(const void* fx, const void* fy, const void* fz, const void* rx,
                           const void* ry, const void* rz, const void* w, long long n_votes,
                           int gx, int gy, int by_n, int bz_n, int pfy, int pfz, int nearest,
                           void* out, void* stream) {
  auto args = [&](auto launch) {
    return launch((const int*)fx, (const int*)fy, (const int*)fz, (const float*)rx,
                  (const float*)ry, (const float*)rz, (const float*)w, n_votes, gx, gy, by_n,
                  bz_n, pfy, pfz, (float*)out, (cudaStream_t)stream);
  };
  return (int)(nearest ? args(launch_bound<true>) : args(launch_bound<false>));
}

// out: zeroed f32 [w8 * w8 * w8]; o: device int32[3].
int cppf_refine_window(const void* o, const void* fx, const void* fy, const void* fz,
                       const void* rx, const void* ry, const void* rz, const void* w,
                       long long n_votes, int w8, int nearest, void* out, void* stream) {
  auto args = [&](auto launch) {
    return launch((const int*)o, (const int*)fx, (const int*)fy, (const int*)fz,
                  (const float*)rx, (const float*)ry, (const float*)rz, (const float*)w,
                  n_votes, w8, (float*)out, (cudaStream_t)stream);
  };
  return (int)(nearest ? args(launch_refine<true>) : args(launch_refine<false>));
}

// out: f32 [cx*cy*cz], zeroed or holding earlier chunks' sums (added to).
int cppf_dense_hist(const void* fx, const void* fy, const void* fz, const void* rx,
                    const void* ry, const void* rz, const void* w, long long n_votes, int cx,
                    int cy, int cz, int px, int py, int pz, int nearest, void* out,
                    void* stream) {
  auto args = [&](auto launch) {
    return launch((const int*)fx, (const int*)fy, (const int*)fz, (const float*)rx,
                  (const float*)ry, (const float*)rz, (const float*)w, n_votes, cx, cy, cz, px,
                  py, pz, (float*)out, (cudaStream_t)stream);
  };
  return (int)(nearest ? args(launch_dense<true>) : args(launch_dense<false>));
}

const char* cppf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
