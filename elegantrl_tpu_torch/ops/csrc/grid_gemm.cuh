// Device pieces for persistent update kernels launched cooperatively, one
// block per SM, that walk every phase of an update with a grid barrier
// between phases (dqn_update.cu; later redesigns of the other update chunks
// can take the same pieces):
//
// - grid_sync: a barrier over every block of the launch (the launch must be
//   cooperative, so that all blocks are resident);
// - Mat: a strided view of a logical matrix, read as 0 outside its extent,
//   with an optional column of ones (a bias gradient is the weight
//   gradient's extra column) and an optional row map onto the head table of
//   a flat parameter buffer;
// - Job / run_jobs: C = A B over 32 x 32 output tiles of one or two jobs,
//   spread over all blocks; a block stages 32 x 32 operand tiles in shared memory, the next
//   tile loaded into registers while the current one is used, and each
//   thread keeps a 2 x 2 register tile of outputs.  The whole depth of a
//   tile is summed inside one block in a fixed order, so a weight gradient
//   needs no partials and no atomics and two runs are bitwise equal.
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
};

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
  return m;
}

__device__ __forceinline__ float mat_at(const Mat& M, const HeadMap& hm, int r, int c) {
  if (r >= M.rows || c >= M.cols) return 0.f;
  if (c == M.ones_col) return 1.f;
  long long base;
  if (M.heads) {
    const int k = head_of(hm, r);
    base = hm.off[k] + (long long)(r - hm.col[k]) * hm.d;
  } else {
    base = (long long)r * M.rs;
  }
  return __ldcg(M.p + base + (long long)c * M.cs);
}

enum EpiKind { EPI_FWD = 0, EPI_DGRAD = 1, EPI_WGRAD = 2 };

// What a tile does with its sums acc(m, n):
// - EPI_FWD: v = acc + bias[n]; pre[m][n] = v (when pre); out[m][n] =
//   gelu(v) or v;
// - EPI_DGRAD: out[m][n] = acc * gelu'(out[m][n]) (gelu) or acc, in place
//   over the pre-activation;
// - EPI_WGRAD: the gradient of a (M, kin) weight and its bias, out at off
//   (or, heads, each head row at its own head), column kin the bias; the
//   squares of what it writes add to the thread's norm partial.
struct Epi {
  int kind;
  float* out;
  float* pre;
  const float* bias;
  int ld, gelu;
  long long off;
  int kin, heads;
};

struct Job {
  Mat A, B;  // A (M, K), B (K, N)
  int M, N, K;
  Epi e;
};

__device__ __forceinline__ void tile_load(const Job& jb, const HeadMap& hm, int m0, int n0,
                                          int k0, float (&ra)[4], float (&rb)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int lo = e & (TILE - 1), hi = e >> 5;
    // consecutive threads walk the operand's unit-stride index
    ra[i] = jb.A.rs == 1 ? mat_at(jb.A, hm, m0 + lo, k0 + hi)
                         : mat_at(jb.A, hm, m0 + hi, k0 + lo);
    rb[i] = jb.B.rs == 1 ? mat_at(jb.B, hm, k0 + lo, n0 + hi)
                         : mat_at(jb.B, hm, k0 + hi, n0 + lo);
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

__device__ __forceinline__ void epilogue(const Job& jb, const HeadMap& hm, int m, int n,
                                         float acc, float& sq) {
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
      const int k = head_of(hm, m), j = m - hm.col[k];
      i = n < e.kin ? hm.off[k] + (long long)j * e.kin + n
                    : hm.off[k] + (long long)hm.width[k] * e.kin + j;
    } else {
      i = n < e.kin ? e.off + (long long)m * e.kin + n : e.off + (long long)jb.M * e.kin + m;
    }
    e.out[i] = acc;
    sq = fmaf(acc, acc, sq);
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

// One 32 x 32 output tile of a job at (m0, n0), over the job's whole depth.
// The job comes by value so that it lives in registers.
__device__ __forceinline__ void gemm_tile(const Job jb, const HeadMap& hm, Smem& sm, int m0,
                                          int n0, float& sq) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float ra[4], rb[4];
  tile_load(jb, hm, m0, n0, 0, ra, rb);
  for (int k0 = 0; k0 < jb.K; k0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    tile_store(jb, sm, ra, rb);
    __syncthreads();
    if (k0 + TILE < jb.K) tile_load(jb, hm, m0, n0, k0 + TILE, ra, rb);
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
      epilogue(jb, hm, m0 + 2 * ty + r, n0 + tx + 16 * c, acc[r][c], sq);
}

__device__ __forceinline__ int tiles_of(const Job& jb) {
  return ((jb.M + TILE - 1) / TILE) * ((jb.N + TILE - 1) / TILE);
}

__device__ __forceinline__ void job_tile(const Job& jb, const HeadMap& hm, Smem& sm, int r,
                                         float& sq) {
  const int tn = (jb.N + TILE - 1) / TILE;
  gemm_tile(jb, hm, sm, (r / tn) * TILE, (r % tn) * TILE, sq);
}

// Every tile of one job, or of two, block b taking tiles b, b + grid, ... in
// order (the first job's, then the second's).  The jobs are indexed only by
// constants, so they stay in registers.
__device__ __forceinline__ void run_jobs(const Job& j0, const HeadMap& hm, Smem& sm,
                                         float& sq) {
  const int n0 = tiles_of(j0);
  for (int t = blockIdx.x; t < n0; t += gridDim.x) job_tile(j0, hm, sm, t, sq);
}

__device__ __forceinline__ void run_jobs(const Job& j0, const Job& j1, const HeadMap& hm,
                                         Smem& sm, float& sq) {
  const int n0 = tiles_of(j0), n1 = tiles_of(j1);
  for (int t = blockIdx.x; t < n0 + n1; t += gridDim.x) {
    if (t < n0) job_tile(j0, hm, sm, t, sq);
    else job_tile(j1, hm, sm, t - n0, sq);
  }
}

}  // namespace gg
