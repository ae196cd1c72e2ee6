// Device pieces for persistent update kernels launched cooperatively, one
// block per SM, that walk every phase of an update with a grid barrier
// between phases (dqn_update.cu, ddpg_update.cu, sac_update.cu):
//
// - grid_sync: a barrier over every block of the launch (the launch must be
//   cooperative, so that all blocks are resident);
// - Mat: a strided view of a logical matrix, read as 0 outside its extent,
//   with an optional column of ones (a bias gradient is the weight
//   gradient's extra column), an optional second source for the columns
//   from c2 on (a net's input [x, a] from two feature-major blocks), and an
//   optional row map: onto the head table of a flat parameter buffer
//   (HeadMap), or rows blocked by hw with a stride hs between blocks (the
//   stacked first layers of an ensemble's heads);
// - Job / run_list: C = A B over 32 x 32 output tiles of any number of
//   jobs, each built by value from its index by a generator, spread over all
//   blocks; a block stages 32 x 32 operand tiles in shared memory, the next
//   tile loaded into registers while the current one is used, and each
//   thread keeps a 2 x 2 register tile of outputs.  A job without a depth
//   split sums the whole depth of a tile inside one block in a fixed order,
//   so a weight gradient needs no partials and no atomics; a job with a
//   depth split kb (a weight gradient over a large batch) has tiles x
//   ceil(K / kb) items, each writing its partial sums to its own copy of the
//   flat gradient (EPI_WGRAD at out + s ps), which reduce_parts sums in split
//   order.  Either way two runs are bitwise equal;
// - reduce_parts, clip_adam: the flat gradient and each block's share of
//   its squared norm, then optax's clip-by-global-norm + Adam (+ Polyak).
//
// Data written during the launch (parameters, activations, gradients) is
// read with __ldcg (L2, not the SM's L1), so that what another SM wrote
// before a barrier is what is read after it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_grad.cuh"

namespace gg {

constexpr int THREADS = 256;  // 16 x 16 threads, 2 x 2 outputs each
constexpr int TILE = 32;      // output tile rows, columns, and depth step
constexpr int LDT = TILE + 1;

struct Smem {
  float a[TILE][LDT];  // A tile, depth-major: a[k][m]
  float b[TILE][LDT];  // B tile, depth-major: b[k][n]
  float red[THREADS / 32][2];
};

// Barrier over every block of a cooperative launch.  bar[0] counts the
// blocks that arrived, bar[1] is the generation; bar[0] starts at 0.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Row r of a head table: head k holds rows [col[k], col[k] + width[k]) of
// the stacked heads, each a (width[k], d) weight at off[k] of a flat buffer
// followed by its bias.
struct HeadMap {
  int n;
  int col[4], width[4];
  long long off[4];
  int d;
};

// (Keep a HeadMap in shared memory: it is indexed by a computed head.)
__device__ __forceinline__ int head_of(const HeadMap& hm, int r) {
  int k = 0;
  while (k + 1 < hm.n && r >= hm.col[k + 1]) ++k;
  return k;
}

struct Mat {
  const float* p;
  long long rs, cs;  // strides of a row and a column
  int rows, cols;    // extent; reads outside it are 0
  int ones_col;      // this column reads 1 (-1: none)
  int heads;         // rows are head-table rows (HeadMap; cs = 1)
  const float* p2;   // columns c >= c2 read p2 at column c - c2, same strides
  int c2;
  int hw;            // > 0: row r at (r / hw) hs + (r % hw) rs
  long long hs;
};

constexpr int NO_COL = 1 << 30;

__device__ __forceinline__ Mat mat(const float* p, long long rs, long long cs, int rows,
                                   int cols, int ones_col = -1, int heads = 0) {
  Mat m;
  m.p = p;
  m.rs = rs;
  m.cs = cs;
  m.rows = rows;
  m.cols = cols;
  m.ones_col = ones_col;
  m.heads = heads;
  m.p2 = nullptr;
  m.c2 = NO_COL;
  m.hw = 0;
  m.hs = 0;
  return m;
}

// [p, p2]: columns [0, c2) from p, the rest from p2 (two feature-major
// blocks of one batch side by side).
__device__ __forceinline__ Mat mat2(const float* p, const float* p2, int c2, long long rs,
                                    long long cs, int rows, int cols, int ones_col = -1) {
  Mat m = mat(p, rs, cs, rows, cols, ones_col);
  m.p2 = p2;
  m.c2 = c2;
  return m;
}

// Rows blocked by hw, hs apart: the stacked weights of heads laid out one
// after another in a flat buffer.
__device__ __forceinline__ Mat mat_blocked(const float* p, long long rs, int rows, int cols,
                                           int hw, long long hs) {
  Mat m = mat(p, rs, 1, rows, cols);
  m.hw = hw;
  m.hs = hs;
  return m;
}

// hm: the head table, read only by a Mat with heads set.  X = false drops
// the tests of a second source and of blocked rows from every load, for a
// kernel whose Mats use neither (K9, dqn_update.cu: 1-3% of its time on an
// H100, scripts/torch_compare_chunks.py).
template <bool X>
__device__ __forceinline__ float mat_at(const Mat& M, const HeadMap* hm, int r, int c) {
  if (r >= M.rows || c >= M.cols) return 0.f;
  if (c == M.ones_col) return 1.f;
  const float* p = M.p;
  if (X && c >= M.c2) {
    p = M.p2;
    c -= M.c2;
  }
  long long base;
  if (M.heads) {
    const int k = head_of(*hm, r);
    base = hm->off[k] + (long long)(r - hm->col[k]) * hm->d;
  } else if (X && M.hw > 0) {
    base = (long long)(r / M.hw) * M.hs + (long long)(r % M.hw) * M.rs;
  } else {
    base = (long long)r * M.rs;
  }
  return __ldcg(p + base + (long long)c * M.cs);
}

enum EpiKind { EPI_FWD = 0, EPI_DGRAD = 1, EPI_WGRAD = 2 };

// What a tile does with its sums acc(m, n):
// - EPI_FWD: v = acc + bias[n]; pre[m][n] = v (when pre); out[m][n] =
//   gelu(v) or v;
// - EPI_DGRAD: out[m][n] = acc * gelu'(out[m][n]) (gelu) or acc, in place
//   over the pre-activation;
// - EPI_WGRAD: the gradient of a (M, kin) weight and its bias, out at off
//   (or, heads, each head row at its own head), column kin the bias; the
//   squares of what it writes add to the thread's norm partial (when sq
//   is given).  The partial sums of depth split s go to out + s ps.
struct Epi {
  int kind;
  float* out;
  float* pre;
  const float* bias;
  int ld, gelu;
  long long off;
  int kin, heads;
  long long ps;
};

struct Job {
  Mat A, B;  // A (M, K), B (K, N)
  int M, N, K;
  Epi e;
  int kb;    // depth of one split (0: the whole depth)
};

template <bool X>
__device__ __forceinline__ void tile_load(const Job& jb, const HeadMap* hm, int m0, int n0,
                                          int k0, float (&ra)[4], float (&rb)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int lo = e & (TILE - 1), hi = e >> 5;
    // consecutive threads walk the operand's unit-stride index
    ra[i] = jb.A.rs == 1 ? mat_at<X>(jb.A, hm, m0 + lo, k0 + hi)
                         : mat_at<X>(jb.A, hm, m0 + hi, k0 + lo);
    rb[i] = jb.B.rs == 1 ? mat_at<X>(jb.B, hm, k0 + lo, n0 + hi)
                         : mat_at<X>(jb.B, hm, k0 + hi, n0 + lo);
  }
}

__device__ __forceinline__ void tile_store(const Job& jb, Smem& sm, const float (&ra)[4],
                                           const float (&rb)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int lo = e & (TILE - 1), hi = e >> 5;
    if (jb.A.rs == 1) sm.a[hi][lo] = ra[i];
    else sm.a[lo][hi] = ra[i];
    if (jb.B.rs == 1) sm.b[lo][hi] = rb[i];
    else sm.b[hi][lo] = rb[i];
  }
}

__device__ __forceinline__ void epilogue(const Job& jb, const HeadMap* hm, int m, int n,
                                         int s, float acc, float* sq) {
  if (m >= jb.M || n >= jb.N) return;
  const Epi& e = jb.e;
  if (e.kind == EPI_FWD) {
    const float v = acc + __ldcg(e.bias + n);
    const long long i = (long long)m * e.ld + n;
    if (e.pre != nullptr) e.pre[i] = v;
    e.out[i] = e.gelu ? mlp::gelu_tanh(v) : v;
  } else if (e.kind == EPI_DGRAD) {
    const long long i = (long long)m * e.ld + n;
    e.out[i] = e.gelu ? acc * mlp::gelu_tanh_grad(__ldcg(e.out + i)) : acc;
  } else {
    long long i;
    if (e.heads) {
      const int k = head_of(*hm, m), j = m - hm->col[k];
      i = n < e.kin ? hm->off[k] + (long long)j * e.kin + n
                    : hm->off[k] + (long long)hm->width[k] * e.kin + j;
    } else {
      i = n < e.kin ? e.off + (long long)m * e.kin + n : e.off + (long long)jb.M * e.kin + m;
    }
    e.out[i + s * e.ps] = acc;
    if (sq != nullptr) *sq = fmaf(acc, acc, *sq);
  }
}

// The sum over the block of each thread's (v0, v1), in one fixed order
// (lanes by the xor tree, then the warps in turn); every thread gets it.
__device__ __forceinline__ float2 block_sum2(float v0, float v1, Smem& sm) {
  v0 = mlp::warp_sum(v0);
  v1 = mlp::warp_sum(v1);
  __syncthreads();  // earlier readers of sm.red are done
  if ((threadIdx.x & 31) == 0) {
    sm.red[threadIdx.x >> 5][0] = v0;
    sm.red[threadIdx.x >> 5][1] = v1;
  }
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  for (int w = 0; w < THREADS / 32; ++w) {
    s.x += sm.red[w][0];
    s.y += sm.red[w][1];
  }
  return s;
}

// One 32 x 32 output tile of a job at (m0, n0), over the depth [k_lo, k_hi)
// of split s (k_lo a multiple of TILE).  The job comes by value so that it
// lives in registers.
template <bool X>
__device__ __forceinline__ void gemm_tile(const Job jb, const HeadMap* hm, Smem& sm, int m0,
                                          int n0, int k_lo, int k_hi, int s, float* sq) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float ra[4], rb[4];
  tile_load<X>(jb, hm, m0, n0, k_lo, ra, rb);
  for (int k0 = k_lo; k0 < k_hi; k0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    tile_store(jb, sm, ra, rb);
    __syncthreads();
    if (k0 + TILE < k_hi) tile_load<X>(jb, hm, m0, n0, k0 + TILE, ra, rb);
#pragma unroll 8
    for (int kk = 0; kk < TILE; ++kk) {
      const float a0 = sm.a[kk][2 * ty], a1 = sm.a[kk][2 * ty + 1];
      const float b0 = sm.b[kk][tx], b1 = sm.b[kk][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      epilogue(jb, hm, m0 + 2 * ty + r, n0 + tx + 16 * c, s, acc[r][c], sq);
}

__device__ __forceinline__ int tiles_of(const Job& jb) {
  return ((jb.M + TILE - 1) / TILE) * ((jb.N + TILE - 1) / TILE);
}

__device__ __forceinline__ int splits_of(const Job& jb) {
  return jb.kb > 0 ? (jb.K + jb.kb - 1) / jb.kb : 1;
}

// Item t of a job: tile t % tiles, depth split t / tiles.
template <bool X>
__device__ __forceinline__ void job_item(const Job& jb, const HeadMap* hm, Smem& sm, int t,
                                         float* sq) {
  const int tn = (jb.N + TILE - 1) / TILE, nt = tiles_of(jb);
  const int s = jb.kb > 0 ? t / nt : 0, r = t - s * nt;
  const int k_lo = jb.kb > 0 ? s * jb.kb : 0;
  const int k_hi = jb.kb > 0 ? min(jb.K, k_lo + jb.kb) : jb.K;
  gemm_tile<X>(jb, hm, sm, (r / tn) * TILE, (r % tn) * TILE, k_lo, k_hi, s, sq);
}

// Every item of jobs gen(0), ..., gen(n - 1), block b taking the items b, b
// + grid, ... of their concatenation.  gen builds a job by value from its
// index (no table indexed by a computed number, so nothing goes to local
// memory).  hm: the head table of Mats and epilogues with heads set; sq:
// the thread's share of the squared norm of what EPI_WGRAD writes, where
// the caller takes the norm from the epilogues and not from reduce_parts.
// A list of constant length (every list but an ensemble's heads) is
// unrolled, so that each job's constant fields (operand layouts, epilogue)
// specialise its own tile loop (4-5% of K7, K8 and K9 on an H100).
template <bool X = true, class Gen>
__device__ __forceinline__ void run_list(const Gen& gen, int n, Smem& sm,
                                         const HeadMap* hm = nullptr, float* sq = nullptr) {
  const int grid = (int)gridDim.x;
  int base = 0;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const Job jb = gen(j);
    const int items = tiles_of(jb) * splits_of(jb);
    int t = ((int)blockIdx.x - base) % grid;
    if (t < 0) t += grid;
    for (; t < items; t += grid) job_item<X>(jb, hm, sm, t, sq);
    base += items;
  }
}

// One layer's forward: out (B, J) = act(in (B, K) W^T + b), W (J, K) at w,
// its bias after it; rows of out (and pre) ld apart.
__device__ __forceinline__ Job fwd_job(const Mat& in, const float* w, int J, int K, int B,
                                       float* out, float* pre, int gelu, int ld) {
  Job j;
  j.A = in;
  j.B = mat(w, 1, K, K, J);  // (k, n) = W[n][k]
  j.M = B;
  j.N = J;
  j.K = K;
  j.e = {EPI_FWD, out, pre, w + (long long)J * K, ld, gelu, 0, 0, 0, 0};
  j.kb = 0;
  return j;
}

// A weight gradient split over the batch: g (M, kin + 1) of a (M, kin)
// weight and its bias at off of a flat gradient, = dz^T [in, 1], dz (B, M)
// with rows ldz apart, inb the (B, kin + 1) operand [in, 1]; split s's
// partial sums at part + s P.
__device__ __forceinline__ Job wgrad_job(const float* dz, int ldz, int M, const Mat& inb,
                                         int kin, int B, float* part, long long off,
                                         long long P, int kb) {
  Job j;
  j.A = mat(dz, 1, ldz, M, B);  // (m, b) = dz[b][m]
  j.B = inb;
  j.M = M;
  j.N = kin + 1;
  j.K = B;
  j.e = {EPI_WGRAD, part, nullptr, nullptr, 0, 0, off, kin, 0, P};
  j.kb = kb;
  return j;
}

// A data gradient: out (B, K) = g (B, J) W, W the (J, K) operand w; times
// gelu'(out) in place over the pre-activation when gelu.
__device__ __forceinline__ Job dgrad_job(const float* g, int ldg, int J, const Mat& w, int K,
                                         int B, float* out, int ldo, int gelu) {
  Job j;
  j.A = mat(g, ldg, 1, B, J);
  j.B = w;
  j.M = B;
  j.N = K;
  j.K = J;
  j.e = {EPI_DGRAD, out, nullptr, nullptr, ldo, gelu, 0, 0, 0, 0};
  j.kb = 0;
  return j;
}

// grad[i] = the sum of part[s P + i] over the splits, in split order; each
// block's share of the squared norm to normpart[block].
__device__ __forceinline__ void reduce_parts(const float* part, int nsplit, long long P,
                                             float* grad, float* normpart, Smem& sm) {
  float sq = 0.f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < P;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nsplit; ++k) s += __ldcg(part + k * P + i);
    grad[i] = s;
    sq = fmaf(s, s, sq);
  }
  const float n = block_sum2(sq, 0.f, sm).x;
  if (threadIdx.x == 0) normpart[blockIdx.x] = n;
}

// optax's clip-by-global-norm + Adam over one net (P floats), then Polyak
// t = t (1 - tau) + p tau when t is given; the norm from every block's
// partial, summed in one fixed order by every block, so that every block
// scales alike.  Skipped entirely when !on: every buffer stays
// bit-identical.
__device__ __forceinline__ void clip_adam(float* p, float* t, float* mu, float* nu,
                                          const float* grad, const float* normpart,
                                          long long P, bool on, float bc1, float bc2,
                                          float lr, float clip_grad, float b1, float b2,
                                          float eps, float tau, Smem& sm) {
  if (!on) return;
  float n = 0.f;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += blockDim.x) n += __ldcg(normpart + k);
  const float gn = sqrtf(block_sum2(n, 0.f, sm).x);
  const float scale = gn < clip_grad ? 1.0f : clip_grad / gn;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < P;
       i += (long long)gridDim.x * blockDim.x) {
    const float g = __ldcg(grad + i) * scale;
    const float m = b1 * __ldcg(mu + i) + (1.0f - b1) * g;
    const float v = b2 * __ldcg(nu + i) + (1.0f - b2) * g * g;
    mu[i] = m;
    nu[i] = v;
    const float pn = __ldcg(p + i) - lr * (m / bc1) / (sqrtf(v / bc2) + eps);
    p[i] = pn;
    if (t != nullptr) t[i] = __ldcg(t + i) * (1.0f - tau) + pn * tau;
  }
}

// sum_i w[i] h[i] over n floats by one warp, lanes striding i; every lane
// gets the same bits (the xor tree adds each pair in both lanes alike).
__device__ __forceinline__ float warp_dot(const float* w, const float* h, int n) {
  float s = 0.f;
  for (int i = threadIdx.x & 31; i < n; i += 32) s = fmaf(__ldcg(w + i), __ldcg(h + i), s);
  return mlp::warp_sum(s);
}

// Block 0's %globaltimer stamp k of update u, of nk an update, when traced.
__device__ __forceinline__ void stamp(unsigned long long* trace, int u, int nk, int k) {
  if (trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    trace[u * nk + k] = ns;
  }
}

inline long long round4(long long n) { return (n + 3) / 4 * 4; }

// Blocks of a cooperative launch of `kernel` (THREADS threads, static
// shared memory): one per SM.  Negative (minus the CUDA error) when the
// card cannot launch cooperatively or cannot hold a block on every SM.
template <class Kernel>
inline int coop_grid(Kernel kernel) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  int coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  return sms;
}

// Zero the barrier, then one cooperative launch of `kernel` over `grid`
// blocks with the argument block `args`; returns the CUDA status.
template <class Kernel, class Args>
inline int coop_launch(Kernel kernel, const Args& args, unsigned int* bar, int grid,
                       cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {(void*)&args};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), params, 0,
                                    st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace gg
