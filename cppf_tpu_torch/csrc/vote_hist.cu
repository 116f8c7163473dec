// Center-vote accumulation kernels for the branch-and-bound peak
// (cppf_tpu_torch/ops/voting.py::ppf_vote_peak) and the dense vote
// histogram (ppf_vote_dense), hand-written for Hopper (sm_90a).  Plain C
// entry points, bound from Python with ctypes
// (cppf_tpu_torch/ops/vote_hist.py); each returns a cudaError_t.
//
// Replaces the TPU kernels of cppf_tpu/ops/pallas/vote_hist.py:
//   bound_projections  <- _bound_kernel  (:64-99,  pl.pallas_call at :126)
//   refine_window      <- _refine_kernel (:143-178, pl.pallas_call at :200)
//   dense_hist         <- _dense_kernel  (:208-251, pl.pallas_call at :310)
//
// A vote is three floors (int32, clipped to [0, g-2]), three fractions and a
// weight (0 marks a masked vote).  The splat is separable, hat_x (x) hat_y
// (x) hat_z, with two taps an axis (trilinear) or one (nearest).  The TPU
// kernels contract one-hot splat matrices on the MXU; on Hopper the natural
// form is a scatter.  dense_hist has its own note below; the rest of this
// one is about the two peak kernels.
//
// One splat core, two vote sources.  splat_bound and splat_window take one
// vote in registers.  Each kernel has two front ends that feed them:
//   * votes (bound_votes_kernel, refine_votes_kernel): the seven flat [V]
//     vectors the TPU kernels take.  Bound: it must read the weight of every
//     vote and the other 24 bytes of every live one (202 MB at the bowl
//     workload's V = 7.2 M: >= 48 us at 3.35 TB/s); the outputs (48 KB,
//     16 KB) are noise and the arithmetic is ~30 operations a vote.
//   * pairs (bound_pairs_kernel, refine_pairs_kernel): the 48 bytes a pair
//     that every vote derives from (voting.py::pair_vote_params: weight,
//     rotation count m, circle center c, axes x and y).  The kernel makes
//     vote i < m in registers, g_k = (c_k + cos(a_i) x_k + sin(a_i) y_k -
//     corner_k) / res with a_i = i 2pi/m, then the validity tests, floor,
//     clip and fraction of voting.py::votes_from_pair_params in that
//     operation order, each step rounded on its own (__fmul_rn, __fadd_rn,
//     __fsub_rn, __fdiv_rn: no fused multiply-add, IEEE division; cos and
//     sin of a_i from a table in shared memory, cosf and sinf at full
//     precision of every angle a pair of m <= n_rots rotations can take).
//     No [P, R] vector exists.  Bound: 4.8 MB of parameters
//     and ~60 operations a vote, some microseconds either way; what holds
//     the kernel is instruction issue for making and addressing the votes.
//
// Lanes on one circle.  Neighbouring rotations of one pair land under two
// voxels apart, so lanes that hold neighbouring votes hit the same cells.
// The pairs front ends give a lane a quarter of a pair's circle (kSplit
// lanes a pair, so that 100 000 pairs fill the card; 1 and 8 lanes a pair
// measured slower), and a warp 32 different circles.  (dense_hist, whose
// adaptive pairs cast 0 to 72 votes each, hands out runs instead.)  The
// votes front end of the bound pass gives a lane four consecutive votes
// (16-byte loads), which puts a warp's lanes four rotations apart; merging
// equal cells by __match_any_sync before the atomic measured five times
// slower than the plain atomics and is not kept.  The window's votes front
// end keeps one vote a lane: the few votes that reach the window are runs of
// neighbouring rotations, and one vote a lane packs a run into one warp pass
// of the splat.
//
// Accumulation.  Each block keeps a private copy of the output in shared
// memory.  A float atomicAdd there compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN) that retries under contention and took four fifths of
// the kernels' time; the copy is therefore int32 fixed point, added to with
// the native ATOMS.ADD.  A block scales by the largest power of two that
// cannot overflow whatever cells its votes hit (a pass over its weights
// first: fixed_scale), which at bowl's shapes is 2^15 (pairs) or 2^16 (votes)
// a unit of weight for the bound pass; the window kernels count only the
// votes in the window's x slab, which no cell of the window can exceed.  The bound pass rounds each tap up, so its sums stay upper
// bounds; the window rounds to nearest.  Sums inside a block no longer
// depend on the order of the votes.
//
// Flush.  A block converts its non-zero cells to float and adds them to the
// output with one global atomicAdd each.  Summing the copies of a
// thread-block cluster through distributed shared memory first, so that one
// add a cell leaves a cluster, measured slower on the H100 at every cluster
// size (fewer resident blocks, two cluster barriers) and is not kept: the
// flush was never the cost.  The launch is as many blocks as are resident at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the shared memory
// asked), or fewer when the work needs fewer.
//
// Window cull (refine_pairs_kernel).  A pair's votes lie on an ellipse about
// c with semi-axes |x| and |y|; a pair whose shell misses the ball around
// the window (plus one voxel) is skipped before any vote is made.  The
// window origin is read from device memory: no host read.  The window's
// fixed-point scale comes from the mass of the votes in its x slab
// (window_scale), not from every vote of the block.
//
// Tolerance.  Kernel and plain version agree to 1e-3 of the largest cell,
// not bit for bit: blocks' sums are added by float atomics in any order;
// fixed point rounds each tap by at most one unit; in the pairs front ends
// cosf may differ from torch.cos in the last bit (where the card's torch.cos
// is not cosf), which moves a trilinear grid by rounding but can move one
// whole vote where the arithmetic has a step (the validity tests g >= 0.01
// and g < d - 1.01, nearest's r > 0.5).
// Most of that allowance is for the plain version's own float32 sums and for
// a vote at a step.  Against the plain version summed in float64 on the same
// votes the kernels are held closer: the window within 1e-5 of the largest
// cell either way (2e-6 measured at the bowl workload), the bound pass, whose
// n taps into a cell each round up by under one unit, between 0 (1e-6
// allowed, for the flush's float adds) below and 1e-4 above (6e-5 measured:
// some 10^5 taps into the largest cell at 2^-15 a unit).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // a block of dense_hist's global route
constexpr int kPeakThreads = 1024;  // a block of the peak kernels, but for:
constexpr int kBoundVotesThreads = 512;  // bound_votes_kernel (four votes a lane)
constexpr int kSplit = 4;  // lanes that share a pair's rotations, a quarter circle each
constexpr float kTwoPi = 6.2831855f;

// One vote in registers: floors, fractions, weight.
struct Vote {
  int x, y, z;
  float ax, ay, az, w;
};

// ---------------------------------------------------------------------------
// The splat core.

// A block accumulates in fixed point: value * scale as int32, scale a power
// of two.  A float atomicAdd on shared memory is a compare-and-swap loop
// (ATOMS.CAST.SPIN) that retries whenever another lane hits the cell; the
// integer add is one native instruction (ATOMS.ADD), and its sums do not
// depend on the order of the votes.  kUp rounds up, which keeps a sum an
// upper bound; else to nearest.
template <bool kUp>
__device__ __forceinline__ int to_fixed(float val, float scale) {
  return kUp ? __float2int_ru(val * scale) : __float2int_rn(val * scale);
}

// The scale for a block whose n votes carry mass = sum |w|: the largest power
// of two with scale * mass + 4 n inside int32.  No cell can hold more than
// every vote's whole weight plus a rounding unit for each of a vote's (at
// most 4) taps into it.
__device__ __forceinline__ float fixed_scale(float mass, float n) {
  if (!(mass > 0.f)) return 1.f;
  const float limit = 2147483000.f - 4.f * n;
  // at most 2^126, so that a vanishing mass cannot make the scale infinite
  float scale = exp2f(floorf(log2f(fminf(limit / mass, 8.5e37f))));
  if (scale * mass > limit) scale *= 0.5f;  // log2f rounded up across a power of two
  return scale;
}

// Block-wide sum (every thread calls it and gets the result).
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
  __shared__ float total;
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < blockDim.x / 32 ? part[threadIdx.x] : 0.f;
    for (int d = 16; d; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (threadIdx.x == 0) total = s;
  }
  __syncthreads();
  return total;
}

// Adds N tap values to base[cell[.]], each rounded up.
template <int N>
__device__ __forceinline__ void add_taps(int* base, float scale, const int* cell,
                                         const float* val) {
#pragma unroll
  for (int j = 0; j < N; ++j) atomicAdd(base + cell[j], to_fixed<true>(val[j], scale));
}

// A block's copy of the projections: Mxy [gx, by_n] | Mxz [gx, bz_n] |
// Myz [gy, bz_n].  Rows are fine x (or y) taps weighted by w; columns are
// the unweighted y (or z) taps pooled by pfy (or pfz).
struct Proj {
  int *xy, *xz, *yz;
  int by_n, bz_n, pfy, pfz;
  float scale;
};

template <bool kNearest>
__device__ __forceinline__ void splat_bound(const Proj& P, const Vote& v) {
  if (kNearest) {
    const int nx = v.ax > 0.5f ? v.x + 1 : v.x;
    const int ny = v.ay > 0.5f ? v.y + 1 : v.y;
    const int nz = v.az > 0.5f ? v.z + 1 : v.z;
    const int cxy = nx * P.by_n + ny / P.pfy;
    const int cxz = nx * P.bz_n + nz / P.pfz;
    const int cyz = ny * P.bz_n + nz / P.pfz;
    add_taps<1>(P.xy, P.scale, &cxy, &v.w);
    add_taps<1>(P.xz, P.scale, &cxz, &v.w);
    add_taps<1>(P.yz, P.scale, &cyz, &v.w);
    return;
  }
  const float hx0 = (1.f - v.ax) * v.w, hx1 = v.ax * v.w;
  const float hy0 = 1.f - v.ay, hy1 = v.ay;
  const float hz0 = 1.f - v.az, hz1 = v.az;
  const int cy0 = v.y / P.pfy, cy1 = (v.y + 1) / P.pfy;
  const int cz0 = v.z / P.pfz, cz1 = (v.z + 1) / P.pfz;
  {
    const int r0 = v.x * P.by_n, r1 = r0 + P.by_n;
    const int cell[4] = {r0 + cy0, r0 + cy1, r1 + cy0, r1 + cy1};
    const float val[4] = {hx0 * hy0, hx0 * hy1, hx1 * hy0, hx1 * hy1};
    add_taps<4>(P.xy, P.scale, cell, val);
  }
  {
    const int r0 = v.x * P.bz_n, r1 = r0 + P.bz_n;
    const int cell[4] = {r0 + cz0, r0 + cz1, r1 + cz0, r1 + cz1};
    const float val[4] = {hx0 * hz0, hx0 * hz1, hx1 * hz0, hx1 * hz1};
    add_taps<4>(P.xz, P.scale, cell, val);
  }
  {
    const float wy0 = hy0 * v.w, wy1 = hy1 * v.w;
    const int r0 = v.y * P.bz_n, r1 = r0 + P.bz_n;
    const int cell[4] = {r0 + cz0, r0 + cz1, r1 + cz0, r1 + cz1};
    const float val[4] = {wy0 * hz0, wy0 * hz1, wy1 * hz0, wy1 * hz1};
    add_taps<4>(P.yz, P.scale, cell, val);
  }
}

// The window's splat: v's floors are relative to the window origin, each in
// [-1, w8) (a floor at -1 still reaches the window with its +1 tap).
template <bool kNearest>
__device__ __forceinline__ void splat_window(int* win, float scale, int w8, const Vote& v) {
  if (kNearest) {
    const int nx = v.ax > 0.5f ? v.x + 1 : v.x;
    const int ny = v.ay > 0.5f ? v.y + 1 : v.y;
    const int nz = v.az > 0.5f ? v.z + 1 : v.z;
    if (nx >= 0 && nx < w8 && ny >= 0 && ny < w8 && nz >= 0 && nz < w8)
      atomicAdd(&win[(nx * w8 + ny) * w8 + nz], to_fixed<false>(v.w, scale));
    return;
  }
  const float hx[2] = {(1.f - v.ax) * v.w, v.ax * v.w};
  const float hy[2] = {1.f - v.ay, v.ay};
  const float hz[2] = {1.f - v.az, v.az};
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const int X = v.x + dx;
    if (X < 0 || X >= w8) continue;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int Y = v.y + dy;
      if (Y < 0 || Y >= w8) continue;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int Z = v.z + dz;
        if (Z < 0 || Z >= w8) continue;
        atomicAdd(&win[(X * w8 + Y) * w8 + Z],
                  to_fixed<false>(hx[dx] * (hy[dy] * hz[dz]), scale));
      }
    }
  }
}

// Adds a block's fixed-point copy into the float out, one global atomicAdd a
// non-zero cell.
__device__ __forceinline__ void flush(const int* copy, int n_cells, float scale, float* out) {
  __syncthreads();
  for (int i = threadIdx.x; i < n_cells; i += blockDim.x)
    if (copy[i] != 0) atomicAdd(out + i, (float)copy[i] / scale);
}

// ---------------------------------------------------------------------------
// Front end 1: votes.  Seven flat [V] streams, four votes a lane from each
// (16-byte loads; the streams are 16-byte aligned), the ragged tail by
// 4-byte loads.

struct Streams {
  const int *fx, *fy, *fz;
  const float *rx, *ry, *rz, *w;
  long long n;
};

__device__ __forceinline__ void load4(const int* p, long long v0, long long n, int* out) {
  if (v0 + 3 < n) {
    const int4 q = *reinterpret_cast<const int4*>(p + v0);
    out[0] = q.x, out[1] = q.y, out[2] = q.z, out[3] = q.w;
  } else {
    for (int j = 0; j < 4; ++j) out[j] = v0 + j < n ? p[v0 + j] : 0;
  }
}

__device__ __forceinline__ void load4(const float* p, long long v0, long long n, float* out) {
  if (v0 + 3 < n) {
    const float4 q = *reinterpret_cast<const float4*>(p + v0);
    out[0] = q.x, out[1] = q.y, out[2] = q.z, out[3] = q.w;
  } else {
    for (int j = 0; j < 4; ++j) out[j] = v0 + j < n ? p[v0 + j] : 0.f;
  }
}

// The fixed-point scale of a block that takes `each` votes a thread from
// first + threadIdx.x * each on, every `step`: a pass over its weights.
__device__ __forceinline__ float votes_scale(const Streams& S, long long first, long long step,
                                             int each) {
  float mass = 0.f, n = 0.f;
  for (long long v0 = first + (long long)threadIdx.x * each; v0 < S.n; v0 += step) {
    for (int j = 0; j < each && v0 + j < S.n; ++j) {
      const float w = S.w[v0 + j];
      if (w != 0.f) mass += fabsf(w), n += 1.f;
    }
  }
  mass = block_sum(mass);
  return fixed_scale(mass, block_sum(n));
}

template <bool kNearest>
__global__ void __launch_bounds__(kPeakThreads) bound_votes_kernel(
    Streams S, int gx, int gy, int by_n, int bz_n, int pfy, int pfz, float* __restrict__ out) {
  extern __shared__ int smem[];
  const int n_xy = gx * by_n, n_xz = gx * bz_n;
  const int n_all = n_xy + n_xz + gy * bz_n;
  for (int i = threadIdx.x; i < n_all; i += blockDim.x) smem[i] = 0;

  const long long n_groups = (S.n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float scale = votes_scale(S, 4 * (long long)blockIdx.x * blockDim.x, 4 * stride, 4);
  const Proj P = {smem, smem + n_xy, smem + n_xy + n_xz, by_n, bz_n, pfy, pfz, scale};
  __syncthreads();
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < n_groups;
       g += stride) {
    const long long v0 = 4 * g;
    float w[4], ax[4], ay[4], az[4];
    int x[4], y[4], z[4];
    load4(S.w, v0, S.n, w);
    if (w[0] == 0.f && w[1] == 0.f && w[2] == 0.f && w[3] == 0.f)
      continue;  // dead votes cost the weight load alone
    load4(S.fx, v0, S.n, x), load4(S.fy, v0, S.n, y), load4(S.fz, v0, S.n, z);
    load4(S.rx, v0, S.n, ax), load4(S.ry, v0, S.n, ay), load4(S.rz, v0, S.n, az);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (w[j] == 0.f) continue;
      const Vote v = {x[j], y[j], z[j], ax[j], ay[j], az[j], w[j]};
      splat_bound<kNearest>(P, v);
    }
  }
  flush(smem, n_all, scale, out);
}

// Exact fine splat mass in the w8^3 window at origin o (device int32[3],
// read here: no host read).  Output [w8, w8*w8], x rows, (y, z) y-major.
template <bool kNearest>
__global__ void __launch_bounds__(kPeakThreads) refine_votes_kernel(
    const int* __restrict__ o, Streams S, int w8, float* __restrict__ out) {
  extern __shared__ int win[];
  const int n_all = w8 * w8 * w8;
  for (int i = threadIdx.x; i < n_all; i += blockDim.x) win[i] = 0;
  const int ox = o[0], oy = o[1], oz = o[2];
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the scale from the mass of the votes in the window's x slab, as
  // refine_pairs_kernel's (window_scale)
  float mass = 0.f, n = 0.f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < S.n; i += stride) {
    const int x = S.fx[i] - ox;
    if (x >= -1 && x < w8 && S.w[i] != 0.f) mass += fabsf(S.w[i]), n += 1.f;
  }
  mass = block_sum(mass);
  const float scale = fixed_scale(mass, block_sum(n));
  __syncthreads();

  // One vote a lane, 4-byte loads: the votes that reach the window are runs
  // of neighbouring rotations, which this mapping packs into one warp pass of
  // the splat; four votes a lane (16-byte loads) spread a run over four
  // passes and measured slower.  Most votes miss the window's x range and
  // cost the fx load alone.
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < S.n; i += stride) {
    Vote v;
    v.x = S.fx[i] - ox;
    if (v.x < -1 || v.x >= w8) continue;
    v.w = S.w[i];
    if (v.w == 0.f) continue;
    v.y = S.fy[i] - oy;
    v.z = S.fz[i] - oz;
    if (v.y < -1 || v.y >= w8 || v.z < -1 || v.z >= w8) continue;
    v.ax = S.rx[i], v.ay = S.ry[i], v.az = S.rz[i];
    splat_window<kNearest>(win, scale, w8, v);
  }
  flush(win, n_all, scale, out);
}

// ---------------------------------------------------------------------------
// Front end 2: pairs.  A lane owns a pair (48 bytes: weight, rotation count
// m, circle center c, axes x and y) and makes its votes in registers,
//   g_k = (c_k + cos(a_i) x_k + sin(a_i) y_k - corner_k) / res,  a_i = i 2pi/m,
// with the arithmetic of voting.py::votes_from_pair_params in its operation
// order, each step rounded on its own (no fused multiply-add), so that a
// vote equals the one PyTorch makes on the card up to cosf against torch.cos.

struct Frame {
  float corner[3], res, hi[3];
  int fmax[3];
};

// frame: device f32 [7] = corner | res | runtime grid dims.
__device__ __forceinline__ Frame load_frame(const float* frame, int gx, int gy, int gz) {
  Frame F;
  const int g[3] = {gx, gy, gz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    F.corner[k] = frame[k];
    F.hi[k] = __fsub_rn(fminf(frame[4 + k], (float)g[k]), 1.01f);
    F.fmax[k] = g[k] - 2;
  }
  F.res = frame[3];
  return F;
}

struct Pair {
  float w;
  int m;
  float c[3], x[3], y[3];
};

// A pair from its three 16-byte rows; its rotation count clipped to the
// circle table's n_rots, as pair_vote_params clips it.
__device__ __forceinline__ Pair unpack_pair(const float4& a, const float4& b, const float4& c,
                                            int n_rots) {
  Pair q;
  q.w = a.x;
  q.m = min(__float_as_int(a.y), n_rots);
  q.c[0] = a.z, q.c[1] = a.w, q.c[2] = b.x;
  q.x[0] = b.y, q.x[1] = b.z, q.x[2] = b.w;
  q.y[0] = c.x, q.y[1] = c.y, q.y[2] = c.z;
  return q;
}

// False for a pair that casts no vote; then only its first 16 bytes are read.
__device__ __forceinline__ bool load_pair(const float4* __restrict__ params, long long p,
                                          int n_rots, Pair& q) {
  const float4 a = params[3 * p];
  if (a.x == 0.f || __float_as_int(a.y) <= 0) return false;
  q = unpack_pair(a, params[3 * p + 1], params[3 * p + 2], n_rots);
  return true;
}

// The circle table: (cos, sin) of a_i = i 2pi/m, as voting.py::_circle
// rounds it, for every rotation count m in [1, n_rots] and i < m, at
// m (m-1) / 2 + i: 2628 angles (21 KB) at 72 rotations.  Adaptive voting
// gives each pair its own m, so a table of one m would leave most votes a
// cosf and a sinf of their own; their slow path (a called reduction for
// huge arguments) also made the callers save registers to the stack.
// Pairs come from pair_vote_params, which clips m to n_rots.
size_t circle_table_bytes(int n_rots) {
  return sizeof(float2) * (size_t)n_rots * (n_rots + 1) / 2;
}

__device__ __forceinline__ void fill_circle_table(float2* table, int n_rots) {
  const int n = n_rots * (n_rots + 1) / 2;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    int m = (int)((sqrtf(8.f * (float)k + 1.f) + 1.f) * 0.5f);  // entry k's row
    while (m * (m - 1) / 2 > k) --m;
    while (m * (m + 1) / 2 <= k) ++m;
    const float a = __fmul_rn((float)(k - m * (m - 1) / 2), __fdiv_rn(kTwoPi, (float)m));
    table[k] = make_float2(cosf(a), sinf(a));
  }
}

// (cos, sin) of vote i of a pair of m <= n_rots rotations.
__device__ __forceinline__ float2 circle_sample(const float2* table, int m, int i) {
  return table[m * (m - 1) / 2 + i];
}

// Axis k of the vote at (cs, sn): false when it lies outside the grid's
// valid range, else its floor (clipped as the plain version clips) and
// fraction.
__device__ __forceinline__ bool vote_axis(const Pair& q, const Frame& F, int k, float cs,
                                          float sn, int& f, float& r) {
  const float pos = __fadd_rn(__fadd_rn(q.c[k], __fmul_rn(cs, q.x[k])), __fmul_rn(sn, q.y[k]));
  const float g = __fdiv_rn(__fsub_rn(pos, F.corner[k]), F.res);
  if (!(g >= 0.01f && g < F.hi[k])) return false;
  f = min(max((int)floorf(g), 0), F.fmax[k]);
  r = __fsub_rn(g, (float)f);
  return true;
}

// Vote i of pair q, whose rotation count is m: false when it lies outside
// the grid's valid range on some axis.
__device__ __forceinline__ bool make_vote(const Pair& q, const Frame& F, const float2* table,
                                          int m, int i, Vote& v) {
  const float2 a = circle_sample(table, m, i);
  v.w = q.w;
  return vote_axis(q, F, 0, a.x, a.y, v.x, v.ax) && vote_axis(q, F, 1, a.x, a.y, v.y, v.ay) &&
         vote_axis(q, F, 2, a.x, a.y, v.z, v.az);
}

// Work item t of n_pairs * kSplit: pair t % n_pairs (a warp holds 32 different
// circles) and the rotations [first, last) of chunk t / n_pairs, a quarter of
// the pair's own m votes.
__device__ __forceinline__ void rotation_range(long long t, long long n_pairs, int n_rots, int m,
                                               int& first, int& last) {
  const int votes = max(min(m, n_rots), 0);
  const int per = (votes + kSplit - 1) / kSplit;
  first = (int)(t / n_pairs) * per;
  last = min(votes, first + per);
}

// The fixed-point scale of a block of a pairs kernel: a pass over the weight
// and rotation count of its work items.
__device__ __forceinline__ float pairs_scale(const float4* __restrict__ params,
                                             long long n_pairs, int n_rots) {
  const long long work = n_pairs * kSplit;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float mass = 0.f, n = 0.f;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < work; t += stride) {
    const float4 a = params[3 * (t % n_pairs)];
    int first, last;
    rotation_range(t, n_pairs, n_rots, __float_as_int(a.y), first, last);
    if (a.x != 0.f && last > first) mass += fabsf(a.x) * (float)(last - first), n += last - first;
  }
  mass = block_sum(mass);
  return fixed_scale(mass, block_sum(n));
}

template <bool kNearest>
__global__ void __launch_bounds__(kPeakThreads) bound_pairs_kernel(
    const float4* __restrict__ params, long long n_pairs, int n_rots,
    const float* __restrict__ frame, int gx, int gy, int gz, int by_n, int bz_n, int pfy,
    int pfz, float* __restrict__ out) {
  extern __shared__ float2 table[];  // the circle table, then the projections
  int* proj = reinterpret_cast<int*>(table + n_rots * (n_rots + 1) / 2);
  const int n_xy = gx * by_n, n_xz = gx * bz_n;
  const int n_all = n_xy + n_xz + gy * bz_n;
  for (int i = threadIdx.x; i < n_all; i += blockDim.x) proj[i] = 0;
  fill_circle_table(table, n_rots);
  const Frame F = load_frame(frame, gx, gy, gz);
  const float scale = pairs_scale(params, n_pairs, n_rots);
  const Proj P = {proj, proj + n_xy, proj + n_xy + n_xz, by_n, bz_n, pfy, pfz, scale};
  __syncthreads();

  const long long work = n_pairs * kSplit;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < work; t += stride) {
    Pair q;
    if (!load_pair(params, t % n_pairs, n_rots, q)) continue;
    int first, last;
    rotation_range(t, n_pairs, n_rots, q.m, first, last);
    for (int i = first; i < last; ++i) {
      Vote v;
      if (make_vote(q, F, table, q.m, i, v)) splat_bound<kNearest>(P, v);
    }
  }
  flush(proj, n_all, scale, out);
}

// The window cull.  The votes of a pair lie on an ellipse about c with
// semi-axes |x| and |y| (x is perpendicular to y), so between the spheres of
// radius min and max of the two.  The votes that reach the window have
// coordinates in [o-1, o+w8): a box of half diagonal sqrt(3)/2 (w8+1) voxels
// about o + (w8-1)/2.  One more voxel of margin covers the rounding.  A pair
// whose shell misses the ball around that box casts nothing into the window.
__device__ __forceinline__ bool shell_reaches_window(const Pair& q, const float* centre,
                                                     float reach) {
  float d2 = 0.f, x2 = 0.f, y2 = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float d = q.c[k] - centre[k];
    d2 += d * d, x2 += q.x[k] * q.x[k], y2 += q.y[k] * q.y[k];
  }
  const float d = sqrtf(d2), rx = sqrtf(x2), ry = sqrtf(y2);
  return d - reach <= fmaxf(rx, ry) && d + reach >= fminf(rx, ry);
}

// The fixed-point scale of a block of refine_pairs_kernel: from the mass of
// the votes of its work items whose x reaches the window's slab [o-1, o+w8),
// a pass that makes one axis of each vote of a pair the cull keeps.  No cell
// of the window can hold more.  At 3 cm a window holds a small share of the
// votes (bookshelf's pooled 152^3), and a scale from every vote's mass left
// a unit of 1e-5 of the largest cell.
__device__ __forceinline__ float window_scale(const float4* __restrict__ params,
                                              long long n_pairs, int n_rots, const Frame& F,
                                              const float2* table, const float* centre,
                                              float reach, int ox, int w8) {
  const long long work = n_pairs * kSplit;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float mass = 0.f, n = 0.f;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < work; t += stride) {
    Pair q;
    if (!load_pair(params, t % n_pairs, n_rots, q)) continue;
    if (!shell_reaches_window(q, centre, reach)) continue;
    int first, last;
    rotation_range(t, n_pairs, n_rots, q.m, first, last);
    for (int i = first; i < last; ++i) {
      const float2 a = circle_sample(table, q.m, i);
      int f;
      float r;
      if (vote_axis(q, F, 0, a.x, a.y, f, r) && f - ox >= -1 && f - ox < w8)
        mass += fabsf(q.w), n += 1.f;
    }
  }
  mass = block_sum(mass);
  return fixed_scale(mass, block_sum(n));
}

template <bool kNearest>
__global__ void __launch_bounds__(kPeakThreads) refine_pairs_kernel(
    const int* __restrict__ o, const float4* __restrict__ params, long long n_pairs, int n_rots,
    const float* __restrict__ frame, int gx, int gy, int gz, int w8, float* __restrict__ out) {
  extern __shared__ float2 table[];  // the circle table, then the window
  int* win = reinterpret_cast<int*>(table + n_rots * (n_rots + 1) / 2);
  const int n_all = w8 * w8 * w8;
  for (int i = threadIdx.x; i < n_all; i += blockDim.x) win[i] = 0;
  fill_circle_table(table, n_rots);
  const Frame F = load_frame(frame, gx, gy, gz);
  const int org[3] = {o[0], o[1], o[2]};
  float centre[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    centre[k] = F.corner[k] + ((float)org[k] + 0.5f * (float)(w8 - 1)) * F.res;
  const float reach = (0.8660254f * (float)(w8 + 1) + 1.f) * F.res;
  __syncthreads();
  const float scale = window_scale(params, n_pairs, n_rots, F, table, centre, reach, org[0], w8);

  const long long work = n_pairs * kSplit;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < work; t += stride) {
    Pair q;
    if (!load_pair(params, t % n_pairs, n_rots, q)) continue;
    if (!shell_reaches_window(q, centre, reach)) continue;
    int first, last;
    rotation_range(t, n_pairs, n_rots, q.m, first, last);
    for (int i = first; i < last; ++i) {
      const float2 a = circle_sample(table, q.m, i);
      const float cs = a.x, sn = a.y;
      Vote v;
      v.w = q.w;
      // an axis that is invalid or misses the window ends the vote
      if (!vote_axis(q, F, 0, cs, sn, v.x, v.ax)) continue;
      v.x -= org[0];
      if (v.x < -1 || v.x >= w8) continue;
      if (!vote_axis(q, F, 1, cs, sn, v.y, v.ay)) continue;
      v.y -= org[1];
      if (v.y < -1 || v.y >= w8) continue;
      if (!vote_axis(q, F, 2, cs, sn, v.z, v.az)) continue;
      v.z -= org[2];
      if (v.z < -1 || v.z >= w8) continue;
      splat_window<kNearest>(win, scale, w8, v);
    }
  }
  flush(win, n_all, scale, out);
}

// ---------------------------------------------------------------------------
// dense_hist: the dense vote histogram [cx, cy, cz], axis k pooled by p_k.
//
// Each axis has its taps (f, 1-r) and (f+1, r), pooled to cells f/p and
// (f+1)/p; when both land in one cell they merge into one tap of weight
// (1-r)+r, so a pool-8 vote costs ~1.4 adds instead of 8.  Nearest splats
// one tap f+(r>0.5).  The caller guarantees (f+1)/p < c on every axis
// (floors clipped to g-2, c >= ceil(g/p)); cell indices of the global grid
// are 64-bit.
//
// The TPU kernel contracts an x one-hot [cx, C] with a (y, z) one-hot
// [cy*cz, C] on the MXU per chunk of C votes, at O(V * cy * cz) compares,
// which caps its (y, z) plane.  On Hopper the natural form is a scatter at
// O(V), with no such cap, over the same splat core as the peak kernels'
// (one vote's pooled taps in registers, pooled_taps) and the same two front
// ends:
//   * votes (dense_votes_kernel): the seven flat [V] vectors, one vote a
//     thread.  Bound: the weight of every vote and the other 24 bytes of
//     every live one (2.1 GB for the zero-shot frame's 2^20-pair chunk of
//     75.5 M votes, 8.7 M live: >= 0.17 ms at 3.35 TB/s).
//   * pairs (dense_pairs_kernel): the 48 bytes of a voting pair and 16 of
//     a dead one, votes made in registers as in the peak kernels (the
//     grid's frame is the vote frame; the cells are its pooling).  The
//     zero-shot path votes adaptively: a pair casts m <= 72 votes (25 on
//     average over the third of the frame's pairs that vote at all, 5 to
//     65 between the 10th and 99th percentile), each angle from the circle
//     table.  A lane a pair would leave a warp waiting on its longest
//     circle (16 % of its lanes busy on the demo frame), so a warp takes 32
//     pairs at a time, cuts each into runs of kRun consecutive rotations,
//     and its lanes take the runs in turn (a prefix sum over the warp finds
//     a run's pair; the 32 pairs wait in shared memory).  Bound: ~27 MB of
//     parameters for the frame's 2^20-pair chunk and ~60 operations a vote,
//     ~10 us; what holds the kernel is the accumulation.
//
// Accumulation, chosen by the grid's size:
//   * a grid that fits one block's shared memory (the sparse route's pooled
//     coarse grid, 40x32x24: 123 KB) is a private int32 fixed-point copy a
//     block, added to with the native ATOMS.ADD (fixed_scale: the largest
//     power of two that cannot overflow the block's vote mass; taps round
//     to nearest) and flushed with one global float atomicAdd a non-zero
//     cell;
//   * a larger grid (the whole frame, 48 MB, which the 50 MB L2 holds; a 48^3
//     window, 442 KB) takes global float atomics, the bound of the route:
//     a lane keeps its last vote's taps in registers and adds into them the
//     taps the next vote of its run shares (absorb), and neighbouring z taps
//     leave as one float4 atomic.
//
// Tolerance.  Against the plain version summed in float64 on the same votes
// the shared route stays within 1e-5 of the largest cell (a fixed-point unit
// of rounding a tap, then the blocks' float flush).  The global route sums
// in float32 like the plain version, in another order: a cell of n taps
// strays by ~sqrt(n) roundings, ~1e-5 of it at n ~ 10^4.  The pairs front
// end makes its own votes: they equal PyTorch's on the card wherever
// torch.cos and torch.sin round as cosf and sinf; a last-bit difference can
// move a vote across a validity step, hence 1e-3 under adaptive voting.
constexpr int kDenseThreads = 1024;  // a block of the shared-memory route
constexpr int kStageBytes = 32 * (3 * 16 + 4);  // a warp's 32 pairs and run starts
// Rotations a lane takes at a time (dense_pairs_kernel): in turns on the demo
// frame's chunk, 4 beat 8 and 16 in shared memory (0.187, 0.215, 0.251 ms),
// 8 held its own against 4 and 16 in device memory, where longer runs merge
// more taps but balance the lanes less.
constexpr int kRunShared = 4;
constexpr int kRunGlobal = 8;

// The pooled taps of one vote: first cell b on each axis and the values of
// cells b + (a, b, c), a, b, c in {0, 1}, at h[(a*2+b)*2+c]; 0 where no tap
// lands.
struct Taps {
  int b[3];
  float h[8];
};

template <bool kNearest>
__device__ __forceinline__ void axis_cells(int f, float r, int p, int& b, float* h) {
  if (kNearest) {
    b = (r > 0.5f ? f + 1 : f) / p;
    h[0] = 1.f, h[1] = 0.f;
    return;
  }
  b = f / p;
  h[0] = 1.f - r, h[1] = r;
  if ((f + 1) / p == b) h[0] += h[1], h[1] = 0.f;
}

// Products in the plain version's order: ((w * hx) * hy) * hz.
template <bool kNearest>
__device__ __forceinline__ Taps pooled_taps(const Vote& v, int px, int py, int pz) {
  Taps t;
  float hx[2], hy[2], hz[2];
  axis_cells<kNearest>(v.x, v.ax, px, t.b[0], hx);
  axis_cells<kNearest>(v.y, v.ay, py, t.b[1], hy);
  axis_cells<kNearest>(v.z, v.az, pz, t.b[2], hz);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c) t.h[(a * 2 + b) * 2 + c] = v.w * hx[a] * hy[b] * hz[c];
  return t;
}

// The values of held's taps that t's cells share move into t (consecutive
// votes of a run lie about a cell apart, so their boxes overlap).  All
// indices are static: a shift by d along one axis, axis by axis.
template <int kStride>
__device__ __forceinline__ void shift_taps(float* g, int d) {
  float s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int bit = (k / kStride) & 1;  // t's tap index on this axis takes held's bit + d
    s[k] = d == 0 ? g[k] : (bit + d == 1 - bit ? g[k ^ kStride] : 0.f);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) g[k] = s[k];
}

__device__ __forceinline__ bool covered(int bit, int d) { return d == 0 || bit - d == 0 || bit - d == 1; }

__device__ __forceinline__ void absorb(Taps& t, Taps& held) {
  const int d0 = t.b[0] - held.b[0], d1 = t.b[1] - held.b[1], d2 = t.b[2] - held.b[2];
  if (d0 < -1 || d0 > 1 || d1 < -1 || d1 > 1 || d2 < -1 || d2 > 1) return;
  float g[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) g[k] = held.h[k];
  shift_taps<4>(g, d0), shift_taps<2>(g, d1), shift_taps<1>(g, d2);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    t.h[k] += g[k];
    if (covered(k >> 2, d0) && covered((k >> 1) & 1, d1) && covered(k & 1, d2)) held.h[k] = 0.f;
  }
}

// Where the taps go: a block's fixed-point copy in shared memory ...
struct SharedSink {
  int* hist;
  float scale;
  int cy, cz;
  __device__ __forceinline__ void line(long long row, int z, float v0, float v1) const {
    int* p = hist + (int)row * cz + z;
    if (v0 != 0.f) atomicAdd(p, to_fixed<false>(v0, scale));
    if (v1 != 0.f) atomicAdd(p + 1, to_fixed<false>(v1, scale));
  }
};

// ... or the float grid in device memory (16-byte aligned), two neighbouring
// z taps in one float4 vector atomic (RED.E.ADD.F32x4) wherever one aligned
// float4 holds both: three times in four.  In turns on the demo frame's
// chunk, float4 took 0.573 ms against 0.670 (float2 at even cells) and 0.929
// (one atomic a tap).
struct GlobalSink {
  float* out;
  long long n_cells;
  int cy, cz;
  __device__ __forceinline__ void line(long long row, int z, float v0, float v1) const {
    const long long i = row * cz + z;
    if (v0 == 0.f || v1 == 0.f) {
      if (v0 != 0.f) atomicAdd(out + i, v0);
      if (v1 != 0.f) atomicAdd(out + i + 1, v1);
      return;
    }
    if ((i & 3) != 3 && (i | 3) < n_cells) {
      const int k = (int)(i & 3);
      const float4 q = make_float4(k == 0 ? v0 : 0.f, k == 0 ? v1 : (k == 1 ? v0 : 0.f),
                                   k == 1 ? v1 : (k == 2 ? v0 : 0.f), k == 2 ? v1 : 0.f);
      atomicAdd(reinterpret_cast<float4*>(out + (i & ~3LL)), q);
      return;
    }
    atomicAdd(out + i, v0);
    atomicAdd(out + i + 1, v1);
  }
};

template <bool kNearest, class Sink>
__device__ __forceinline__ void emit(const Taps& t, const Sink& s) {
  constexpr int n = kNearest ? 1 : 2;
#pragma unroll
  for (int a = 0; a < n; ++a)
#pragma unroll
    for (int b = 0; b < n; ++b)
      s.line((long long)(t.b[0] + a) * s.cy + t.b[1] + b, t.b[2], t.h[(a * 2 + b) * 2],
             kNearest ? 0.f : t.h[(a * 2 + b) * 2 + 1]);
}

template <bool kNearest, bool kShared>
__global__ void __launch_bounds__(kShared ? kDenseThreads : kThreads) dense_votes_kernel(
    Streams S, long long n_cells, int cy, int cz, int px, int py, int pz, float* __restrict__ out) {
  extern __shared__ int hist[];
  const long long stride = kShared ? (long long)gridDim.x * blockDim.x : 0;
  float scale = 1.f;
  if (kShared) {
    for (int i = threadIdx.x; i < n_cells; i += blockDim.x) hist[i] = 0;
    scale = votes_scale(S, (long long)blockIdx.x * blockDim.x, stride, 1);
    __syncthreads();
  }
  const SharedSink shared = {hist, scale, cy, cz};
  const GlobalSink global = {out, n_cells, cy, cz};
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < S.n;
       v += kShared ? stride : S.n) {
    const float w = S.w[v];
    if (w == 0.f) continue;  // dead votes cost the weight load alone
    const Vote vote = {S.fx[v], S.fy[v], S.fz[v], S.rx[v], S.ry[v], S.rz[v], w};
    const Taps t = pooled_taps<kNearest>(vote, px, py, pz);
    if (kShared)
      emit<kNearest>(t, shared);
    else
      emit<kNearest>(t, global);
  }
  if (kShared) flush(hist, (int)n_cells, scale, out);
}

// The votes of rotations [first, last) of pair q, made in registers and
// splatted; with kMerge (trilinear only) a vote's taps that the next vote
// shares are added to it in registers instead of to the sink.  The global
// route merges (0.486 against 0.573 ms in turns on the demo frame's chunk,
// both with float4 atomics; 2.03 against 2.41 ms on the whole frame; a 48^3
// window, where most votes miss, lost: 0.058 against 0.042); the shared
// route, whose atomics are cheap, does not (0.30 against 0.22 ms).
template <bool kNearest, bool kMerge, class Sink>
__device__ __forceinline__ void cast_run(const Pair& q, int first, int last, const float2* table,
                                         const Frame& F, int px, int py, int pz,
                                         const Sink& sink) {
  constexpr bool merge = kMerge && !kNearest;
  Taps held;
  bool holding = false;
  for (int i = first; i < last; ++i) {
    Vote v;
    if (!make_vote(q, F, table, q.m, i, v)) continue;
    Taps t = pooled_taps<kNearest>(v, px, py, pz);
    if (!merge) {
      emit<kNearest>(t, sink);
      continue;
    }
    if (holding) {
      absorb(t, held);
      emit<kNearest>(held, sink);
    }
    held = t;
    holding = true;
  }
  if (merge && holding) emit<kNearest>(held, sink);
}

// The pairs of warp-batch `base` on: lanes of every warp of the grid take 32
// pairs at a time, warp w of block b at ((b * warps + w) + k * all warps) * 32.
__device__ __forceinline__ long long first_batch() {
  return ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32;
}

__device__ __forceinline__ long long batch_step() {
  return (long long)gridDim.x * (blockDim.x >> 5) * 32;
}

// The fixed-point scale of a block of dense_pairs_kernel: a pass over the
// weight and rotation count of its pairs.
__device__ __forceinline__ float dense_pairs_scale(const float4* __restrict__ params,
                                                   long long n_pairs, int n_rots) {
  float mass = 0.f, n = 0.f;
  for (long long p = first_batch() + (threadIdx.x & 31); p < n_pairs; p += batch_step()) {
    const float4 a = params[3 * p];
    const int m = min(__float_as_int(a.y), n_rots);
    if (a.x != 0.f && m > 0) mass += fabsf(a.x) * (float)m, n += m;
  }
  mass = block_sum(mass);
  return fixed_scale(mass, block_sum(n));
}

// Shared memory: per warp its 32 pairs (float4 x 3 each) and run starts,
// then the circle table, then (kShared) the block's fixed-point grid.
template <bool kNearest, bool kShared>
__global__ void __launch_bounds__(kShared ? kDenseThreads : kThreads) dense_pairs_kernel(
    const float4* __restrict__ params, long long n_pairs, int n_rots,
    const float* __restrict__ frame, int gx, int gy, int gz, long long n_cells, int cy, int cz,
    int px, int py, int pz, float* __restrict__ out) {
  constexpr int run = kShared ? kRunShared : kRunGlobal;
  extern __shared__ float4 smem4[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* stage = smem4 + warp * 96;
  int* const all_starts = reinterpret_cast<int*>(smem4 + warps * 96);
  int* starts = all_starts + warp * 32;
  float2* table = reinterpret_cast<float2*>(all_starts + warps * 32);
  int* hist = reinterpret_cast<int*>(table + n_rots * (n_rots + 1) / 2);
  fill_circle_table(table, n_rots);
  const Frame F = load_frame(frame, gx, gy, gz);
  float scale = 1.f;
  if (kShared) {
    for (int i = threadIdx.x; i < n_cells; i += blockDim.x) hist[i] = 0;
    scale = dense_pairs_scale(params, n_pairs, n_rots);
  }
  __syncthreads();
  const SharedSink shared = {hist, scale, cy, cz};
  const GlobalSink global = {out, n_cells, cy, cz};

  for (long long base = first_batch(); base < n_pairs; base += batch_step()) {
    const long long p = base + lane;
    int runs = 0;
    if (p < n_pairs) {
      const float4 a = params[3 * p];
      const int m = min(__float_as_int(a.y), n_rots);
      if (a.x != 0.f && m > 0) {  // a dead pair costs its first 16 bytes alone
        runs = (m + run - 1) / run;
        stage[3 * lane] = a;
        stage[3 * lane + 1] = params[3 * p + 1];
        stage[3 * lane + 2] = params[3 * p + 2];
      }
    }
    int end = runs;  // inclusive prefix sum of the runs over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, end, d);
      if (lane >= d) end += y;
    }
    starts[lane] = end - runs;
    const int total = __shfl_sync(0xffffffffu, end, 31);
    __syncwarp();
    for (int r = lane; r < total; r += 32) {
      int o = 0;  // the run's pair: the last lane whose runs start at or before r
#pragma unroll
      for (int s = 16; s; s >>= 1)
        if (starts[o + s] <= r) o += s;
      const Pair q = unpack_pair(stage[3 * o], stage[3 * o + 1], stage[3 * o + 2], n_rots);
      const int first = (r - starts[o]) * run;
      const int last = min(q.m, first + run);
      if (kShared)
        cast_run<kNearest, false>(q, first, last, table, F, px, py, pz, shared);
      else
        cast_run<kNearest, true>(q, first, last, table, F, px, py, pz, global);
    }
    __syncwarp();
  }
  if (kShared) flush(hist, (int)n_cells, scale, out);
}

// Enough blocks to fill every SM at the occupancy the shared memory allows,
// and no more than the work items (one a thread) need.
template <typename Kernel>
cudaError_t grid_size(Kernel kernel, size_t smem, long long n_items, int* blocks,
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
  const long long need = (n_items + threads - 1) / threads;
  const long long fill = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(need < fill ? need : fill);
  return cudaSuccess;
}

// The opt-in shared memory of a block on this device.
cudaError_t smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

template <bool kNearest>
cudaError_t launch_dense_votes(const Streams& S, int cx, int cy, int cz, int px, int py, int pz,
                               float* out, cudaStream_t stream) {
  const long long n_cells = (long long)cx * cy * cz;
  int smem_max = 0;
  cudaError_t e = smem_limit(&smem_max);
  if (e != cudaSuccess) return e;
  if (n_cells * (long long)sizeof(int) + 256 <= smem_max) {
    const size_t smem = sizeof(int) * (size_t)n_cells;
    int blocks = 0;
    e = grid_size(dense_votes_kernel<kNearest, true>, smem, S.n, &blocks, kDenseThreads);
    if (e != cudaSuccess) return e;
    dense_votes_kernel<kNearest, true><<<blocks, kDenseThreads, smem, stream>>>(
        S, n_cells, cy, cz, px, py, pz, out);
  } else {
    const long long blocks = (S.n + kThreads - 1) / kThreads;
    dense_votes_kernel<kNearest, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        S, n_cells, cy, cz, px, py, pz, out);
  }
  return cudaGetLastError();
}

template <bool kNearest>
cudaError_t launch_dense_pairs(const float4* params, long long n_pairs, int n_rots,
                               const float* frame, int gx, int gy, int gz, int cx, int cy, int cz,
                               int px, int py, int pz, float* out, cudaStream_t stream) {
  const long long n_cells = (long long)cx * cy * cz;
  int smem_max = 0;
  cudaError_t e = smem_limit(&smem_max);
  if (e != cudaSuccess) return e;
  const size_t fixed = circle_table_bytes(n_rots);
  const size_t shared = (kDenseThreads / 32) * (size_t)kStageBytes + fixed + 4 * n_cells;
  int blocks = 0;
  if (shared + 256 <= (size_t)smem_max) {
    auto kernel = dense_pairs_kernel<kNearest, true>;
    if ((e = grid_size(kernel, shared, n_pairs, &blocks, kDenseThreads)) != cudaSuccess) return e;
    kernel<<<blocks, kDenseThreads, shared, stream>>>(params, n_pairs, n_rots, frame, gx, gy, gz,
                                                      n_cells, cy, cz, px, py, pz, out);
  } else {
    auto kernel = dense_pairs_kernel<kNearest, false>;
    const size_t smem = (kThreads / 32) * (size_t)kStageBytes + fixed;
    if ((e = grid_size(kernel, smem, n_pairs, &blocks, kThreads)) != cudaSuccess) return e;
    kernel<<<blocks, kThreads, smem, stream>>>(params, n_pairs, n_rots, frame, gx, gy, gz, n_cells,
                                               cy, cz, px, py, pz, out);
  }
  return cudaGetLastError();
}

// Launches a peak kernel over `work` items: as many blocks as are resident
// at once with this much shared memory, or fewer when the work needs fewer.
template <typename... KArgs, typename... Args>
cudaError_t launch_peak(void (*kernel)(KArgs...), long long work, int threads, size_t smem,
                        cudaStream_t stream, Args... args) {
  int blocks = 0;
  cudaError_t e = grid_size(kernel, smem, work, &blocks, threads);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point returns a cudaError_t (0 on success).

// out: zeroed f32 [gx*by_n + gx*bz_n + gy*bz_n] = Mxy | Mxz | Myz.
int cppf_bound_projections(const void* fx, const void* fy, const void* fz, const void* rx,
                           const void* ry, const void* rz, const void* w, long long n_votes,
                           int gx, int gy, int by_n, int bz_n, int pfy, int pfz, int nearest,
                           void* out, void* stream) {
  const Streams S = {(const int*)fx,   (const int*)fy,   (const int*)fz,  (const float*)rx,
                     (const float*)ry, (const float*)rz, (const float*)w, n_votes};
  const size_t smem = sizeof(int) * ((size_t)gx * by_n + (size_t)gx * bz_n + (size_t)gy * bz_n);
  auto go = [&](auto kernel) {
    return (int)launch_peak(kernel, (n_votes + 3) / 4, kBoundVotesThreads, smem,
                            (cudaStream_t)stream, S, gx, gy, by_n, bz_n, pfy, pfz, (float*)out);
  };
  return nearest ? go(bound_votes_kernel<true>) : go(bound_votes_kernel<false>);
}

// out: zeroed f32 [w8 * w8 * w8]; o: device int32[3].
int cppf_refine_window(const void* o, const void* fx, const void* fy, const void* fz,
                       const void* rx, const void* ry, const void* rz, const void* w,
                       long long n_votes, int w8, int nearest, void* out, void* stream) {
  const Streams S = {(const int*)fx,   (const int*)fy,   (const int*)fz,  (const float*)rx,
                     (const float*)ry, (const float*)rz, (const float*)w, n_votes};
  const size_t smem = sizeof(int) * (size_t)w8 * w8 * w8;
  auto go = [&](auto kernel) {
    return (int)launch_peak(kernel, n_votes, kPeakThreads, smem, (cudaStream_t)stream,
                            (const int*)o, S, w8, (float*)out);
  };
  return nearest ? go(refine_votes_kernel<true>) : go(refine_votes_kernel<false>);
}

// params: f32 [n_pairs, 12] of voting.py::pair_vote_params; frame: device
// f32 [7] = corner | res | runtime grid dims; out as cppf_bound_projections.
int cppf_bound_projections_pairs(const void* params, long long n_pairs, int n_rots,
                                 const void* frame, int gx, int gy, int gz, int by_n, int bz_n,
                                 int pfy, int pfz, int nearest, void* out, void* stream) {
  const size_t smem = sizeof(int) * ((size_t)gx * by_n + (size_t)gx * bz_n + (size_t)gy * bz_n) +
                      circle_table_bytes(n_rots);
  auto go = [&](auto kernel) {
    return (int)launch_peak(kernel, n_pairs * kSplit, kPeakThreads, smem, (cudaStream_t)stream,
                            (const float4*)params, n_pairs, n_rots, (const float*)frame, gx, gy,
                            gz, by_n, bz_n, pfy, pfz, (float*)out);
  };
  return nearest ? go(bound_pairs_kernel<true>) : go(bound_pairs_kernel<false>);
}

// As cppf_refine_window, from pair parameters.
int cppf_refine_window_pairs(const void* o, const void* params, long long n_pairs, int n_rots,
                             const void* frame, int gx, int gy, int gz, int w8, int nearest,
                             void* out, void* stream) {
  const size_t smem = sizeof(int) * (size_t)w8 * w8 * w8 + circle_table_bytes(n_rots);
  auto go = [&](auto kernel) {
    return (int)launch_peak(kernel, n_pairs * kSplit, kPeakThreads, smem, (cudaStream_t)stream,
                            (const int*)o, (const float4*)params, n_pairs, n_rots,
                            (const float*)frame, gx, gy, gz, w8, (float*)out);
  };
  return nearest ? go(refine_pairs_kernel<true>) : go(refine_pairs_kernel<false>);
}

// out: f32 [cx*cy*cz], 16-byte aligned, zeroed or holding earlier chunks'
// sums (added to).
int cppf_dense_hist(const void* fx, const void* fy, const void* fz, const void* rx,
                    const void* ry, const void* rz, const void* w, long long n_votes, int cx,
                    int cy, int cz, int px, int py, int pz, int nearest, void* out,
                    void* stream) {
  const Streams S = {(const int*)fx,   (const int*)fy,   (const int*)fz,  (const float*)rx,
                     (const float*)ry, (const float*)rz, (const float*)w, n_votes};
  auto go = [&](auto launch) {
    return (int)launch(S, cx, cy, cz, px, py, pz, (float*)out, (cudaStream_t)stream);
  };
  return nearest ? go(launch_dense_votes<true>) : go(launch_dense_votes<false>);
}

// params: f32 [n_pairs, 12] of voting.py::pair_vote_params; frame: device
// f32 [7] = corner | res | runtime grid dims of the fine grid [gx, gy, gz];
// out as cppf_dense_hist, its cells c_k >= ceil(g_k / p_k).
int cppf_dense_hist_pairs(const void* params, long long n_pairs, int n_rots, const void* frame,
                          int gx, int gy, int gz, int cx, int cy, int cz, int px, int py, int pz,
                          int nearest, void* out, void* stream) {
  auto go = [&](auto launch) {
    return (int)launch((const float4*)params, n_pairs, n_rots, (const float*)frame, gx, gy, gz,
                       cx, cy, cz, px, py, pz, (float*)out, (cudaStream_t)stream);
  };
  return nearest ? go(launch_dense_pairs<true>) : go(launch_dense_pairs<false>);
}

const char* cppf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
