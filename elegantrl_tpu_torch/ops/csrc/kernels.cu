// The three kernels of elegantrl_tpu/ops/pallas_kernels.py, for Hopper:
//
// 1. gae_vtrace_kernel (K10) replaces gae_vtrace_pallas (:123; kernel
//    _gae_kernel :99, pallas_call :146): the reverse V-trace recursion
//      m = undone * gamma
//      adv[t] = ((r[t] + m * next_v) - v[t]) + (m * lam) * adv[t+1]
//      next_v = v[t], starting from next_value and adv = 0.
//    Bound on this card: bytes (r, u, v read and adv written once, 16 B a
//    cell: 1.25 us at 4096 envs x 64 steps).  Design: one thread per env
//    column walks t = H-1 ... 0; each time row is contiguous over N, so a
//    warp's loads coalesce.  The TPU kernel's 128-lane blocks were its tile
//    and are not part of the function: any N runs.  Every operation is an
//    explicit round-to-nearest intrinsic in the plain loop's order (nvcc
//    would contract a*b+c into an FMA), so the result is bitwise the plain
//    version's (ops/kernels.py:gae_vtrace_reference).
//
// 2. gather_fields_kernel (K11a) replaces buffer_gather (:62; kernel
//    _gather_kernel :48, pallas_call :84): out[b] = buf[ids0[b] + offset,
//    ids1[b], :] for a (T, N, row) buffer of any dtype, int32 or int64 ids,
//    for up to eight fields of the replay ring in one launch.
//    Bound: bytes (the gathered rows read and written once, plus the ids):
//    about 0.1-0.4 us at a chunk's shapes, so launch and host time set the
//    time.  Design: the wrapper sends a table of fields (base, row bytes,
//    T, N, row offset, output and its byte strides), passed by value as one
//    kernel parameter, so one launch gathers every field of a minibatch
//    chunk (blockIdx.z = field, blockIdx.y = the leading index c of the
//    ids, blockIdx.x = a tile of 256 samples).  Rows are copied as 16-byte
//    vectors where the row bytes and both pointers allow it, else 4-byte
//    words, else bytes; 2^k threads share one sample (k from the row's
//    vector count), so the sample index comes from the thread coordinates
//    by shifts, with no divide per word.  The output strides let a (T, N,
//    dim) field come out feature-major, (..., dim, B), the layout the update
//    chunks read: one thread per sample then writes its row's words B apart,
//    so a warp's stores coalesce.  The TPU kernel's per-row DMAs and its
//    padding of B to 8 were its way to move rows into VMEM; a copy is
//    bitwise buf[ids0, ids1] (negative ids wrap as in PyTorch; ids out of
//    range are the caller's fault, as no check can raise from here).
//
// 3. fused_mlp3_kernel (K11b) replaces fused_mlp3 (:172; kernel
//    _mlp3_kernel :161, pallas_call :184): gelu(gelu(x W0^T + b0) W1^T + b1)
//    W2^T + b2 with tanh-GELU (jax.nn.gelu's default), weights in the port's
//    (out, in) layout, f32.  Bound: operations, 2 B (S D1 + D1 D2 + D2 A)
//    FLOP on the FP32 cores (8.6 us at (8, 128, 128, 2), B = 16,384), at
//    every B this slice runs; the weights are read once.  Design: one block of 256 threads per 32 rows of x; the rows'
//    input and both hidden activations stay in shared memory and only the
//    output is written.  The TPU kernel kept all three weights in VMEM; at
//    (256, 256) they take 274,432 B, more than a block's 227 KB, so each W is
//    streamed through shared memory in (32 k x 64 j) tiles, the next tile
//    loaded into registers while the current one is used, and every thread
//    accumulates a 2 x 4 register tile of outputs.  At a rollout's B = 64
//    two blocks run, so the chain of tiles, not the FLOP, sets the time.
//    tanhf is the accurate one: the library is built without
//    --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_grad.cuh"

namespace {

// ---------------------------------------------------------------- K10 GAE

__global__ void gae_vtrace_kernel(const float* __restrict__ r, const float* __restrict__ u,
                                  const float* __restrict__ v, const float* __restrict__ nv0,
                                  float* __restrict__ adv, int H, int N, float gamma,
                                  float lam) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float next_v = nv0[n], a = 0.f;
  for (int t = H - 1; t >= 0; --t) {
    const size_t i = (size_t)t * N + n;
    const float m = __fmul_rn(u[i], gamma);
    const float vt = v[i];
    a = __fadd_rn(__fsub_rn(__fadd_rn(r[i], __fmul_rn(m, next_v)), vt),
                  __fmul_rn(__fmul_rn(m, lam), a));
    adv[i] = a;
    next_v = vt;
  }
}

// ---------------------------------------------------------- K11a gather

constexpr int GATHER_MAX_FIELDS = 8;
constexpr int GATHER_SAMPLES = 256;  // samples per block (and threads per block)
constexpr int GATHER_DESC = 11;      // int64 words per field in the host's table

struct GatherField {
  const uint8_t* buf;
  uint8_t* out;
  long long T, N, row_bytes, offset;
  long long out_c, out_b, out_u;  // output byte strides of c, sample b, copy unit u
  int unit;                       // bytes per copy: 16, 4 or 1
  int tps_log2;                   // log2 of the threads that share one sample
};

struct GatherParams {
  GatherField f[GATHER_MAX_FIELDS];
  const void* ids0;
  const void* ids1;
  long long Bl;  // samples per leading index (the ids' last axis)
};

template <typename I>
__global__ void __launch_bounds__(GATHER_SAMPLES) gather_fields_kernel(const GatherParams P) {
  const GatherField F = P.f[blockIdx.z];
  const long long c = blockIdx.y;
  const I* i0 = (const I*)P.ids0 + c * P.Bl;
  const I* i1 = (const I*)P.ids1 + c * P.Bl;
  const int tps = 1 << F.tps_log2;
  const int lane = threadIdx.x & (tps - 1);
  const int units = (int)(F.row_bytes / F.unit);
  uint8_t* out_c = F.out + c * F.out_c;
  for (int j = threadIdx.x >> F.tps_log2; j < GATHER_SAMPLES; j += GATHER_SAMPLES >> F.tps_log2) {
    const long long b = (long long)blockIdx.x * GATHER_SAMPLES + j;
    if (b >= P.Bl) break;
    long long t = (long long)__ldg(i0 + b) + F.offset, n = (long long)__ldg(i1 + b);
    if (t < 0) t += F.T;
    if (n < 0) n += F.N;
    const uint8_t* src = F.buf + (t * F.N + n) * F.row_bytes;
    uint8_t* dst = out_c + b * F.out_b;
    if (F.unit == 16) {
      for (int u = lane; u < units; u += tps)
        *(uint4*)(dst + u * F.out_u) = __ldg((const uint4*)src + u);
    } else if (F.unit == 4) {
      for (int u = lane; u < units; u += tps)
        *(uint32_t*)(dst + u * F.out_u) = __ldg((const uint32_t*)src + u);
    } else {
      for (int u = lane; u < units; u += tps) dst[u * F.out_u] = src[u];
    }
  }
}

// ----------------------------------------------------------- K11b MLP3

constexpr int BM = 32;       // rows of x per block
constexpr int JT = 64;       // output columns per pass
constexpr int KT = 32;       // depth of a streamed weight tile
constexpr int THREADS = 256; // 16 x 16: 2 rows x 4 columns each

__host__ __device__ inline int mlp3_ld(int k) { return k | 1; }

constexpr int PER = KT * JT / THREADS;  // weights each thread stages per tile

// Tile t of a layer's weights, (KT k) x (JT j) in (k-tile, j-chunk) order
// with k fastest, into registers: consecutive threads read consecutive k of
// one row of W, so the loads coalesce.
__device__ __forceinline__ void mlp3_fetch(const float* __restrict__ W, int K, int J, int nk,
                                           int t, float (&next)[PER]) {
  const int j0 = (t / nk) * JT, k0 = (t % nk) * KT;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = threadIdx.x + p * THREADS, kk = i % KT, jj = i / KT;
    const int j = j0 + jj, k = k0 + kk;
    next[p] = (j < J && k < K) ? __ldg(W + (size_t)j * K + k) : 0.f;
  }
}

// out[m][j] = act(sum_k in[m][k] W[j][k] + b[j]) for the block's BM rows.
// ``in`` is in shared memory (leading dimension ldi); ``out`` is shared (ldo)
// or, with TO_GLOBAL, the output rows of this block, ``rows`` of them valid.
// The next weight tile is loaded into registers while the current one is
// used, so a tile's load latency hides behind the previous tile's products.
template <bool GELU, bool TO_GLOBAL>
__device__ void mlp3_layer(const float* __restrict__ W, const float* __restrict__ b,
                           const float* in, int ldi, int K, int J, float* out, int ldo,
                           float* ws, int rows) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nk = (K + KT - 1) / KT, ntiles = nk * ((J + JT - 1) / JT);
  float next[PER];
  float acc[2][4];
  mlp3_fetch(W, K, J, nk, 0, next);
  for (int t = 0; t < ntiles; ++t) {
    const int kt = t % nk, j0 = (t / nk) * JT, k0 = kt * KT;
    if (kt == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }
    __syncthreads();  // the previous tile's readers (and layer's writers) are done
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = threadIdx.x + p * THREADS;
      ws[(i % KT) * (JT + 1) + i / KT] = next[p];
    }
    __syncthreads();
    if (t + 1 < ntiles) mlp3_fetch(W, K, J, nk, t + 1, next);
    const int kmax = min(KT, K - k0);
    const float* a0p = in + (ty * 2) * ldi + k0;
    const float* a1p = a0p + ldi;
    for (int kk = 0; kk < kmax; ++kk) {
      const float a0 = a0p[kk], a1 = a1p[kk];
      const float* wr = ws + kk * (JT + 1) + tx;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float w = wr[16 * c];
        acc[0][c] = fmaf(a0, w, acc[0][c]);
        acc[1][c] = fmaf(a1, w, acc[1][c]);
      }
    }
    if (kt != nk - 1) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = ty * 2 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx + 16 * c;
        if (j >= J) continue;
        float val = acc[r][c] + __ldg(b + j);
        if (GELU) val = mlp::gelu_tanh(val);
        if (TO_GLOBAL) {
          if (m < rows) out[(size_t)m * ldo + j] = val;
        } else {
          out[m * ldo + j] = val;
        }
      }
    }
  }
}

// Shared memory: buffer A holds x, later the second hidden layer; buffer B
// the first hidden layer; then one weight tile.
__host__ __device__ inline int mlp3_smem_floats(int S, int D1, int D2) {
  const int lda = mlp3_ld(S > D2 ? S : D2);
  return BM * lda + BM * mlp3_ld(D1) + KT * (JT + 1);
}

__global__ void fused_mlp3_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                                  const float* __restrict__ b0, const float* __restrict__ w1,
                                  const float* __restrict__ b1, const float* __restrict__ w2,
                                  const float* __restrict__ b2, float* __restrict__ out,
                                  int B, int S, int D1, int D2, int A) {
  extern __shared__ float smem[];
  const int lda = mlp3_ld(S > D2 ? S : D2), ldb = mlp3_ld(D1);
  float* bufa = smem;
  float* bufb = bufa + BM * lda;
  float* ws = bufb + BM * ldb;
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, B - m0);
  for (int i = threadIdx.x; i < BM * S; i += THREADS) {
    const int m = i / S, k = i - m * S;
    bufa[m * lda + k] = m < rows ? x[(size_t)(m0 + m) * S + k] : 0.f;
  }
  mlp3_layer<true, false>(w0, b0, bufa, lda, S, D1, bufb, ldb, ws, rows);
  mlp3_layer<true, false>(w1, b1, bufb, ldb, D1, D2, bufa, lda, ws, rows);
  mlp3_layer<false, true>(w2, b2, bufa, lda, D2, A, out + (size_t)m0 * A, A, ws, rows);
}

}  // namespace

extern "C" int gae_vtrace(const void* r, const void* u, const void* v, const void* nv,
                          void* adv, int H, int N, float gamma, float lam, void* stream) {
  const int threads = 256;
  gae_vtrace_kernel<<<(N + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)u, (const float*)v, (const float*)nv, (float*)adv, H, N,
      gamma, lam);
  return (int)cudaGetLastError();
}

// desc: nf rows of GATHER_DESC int64 words (buf, out, T, N, row_bytes,
// offset, out_c, out_b, out_u, unit, tps_log2); the ids are (C, Bl),
// int64 when idx64, else int32.
extern "C" int buffer_gather_fields(const long long* desc, int nf, const void* ids0,
                                    const void* ids1, long long C, long long Bl, int idx64,
                                    void* stream) {
  if (nf < 1 || nf > GATHER_MAX_FIELDS || C > 65535) return (int)cudaErrorInvalidValue;
  if (C == 0 || Bl == 0) return 0;
  GatherParams P;
  for (int k = 0; k < nf; ++k) {
    const long long* d = desc + (size_t)k * GATHER_DESC;
    GatherField& F = P.f[k];
    F.buf = (const uint8_t*)d[0];
    F.out = (uint8_t*)d[1];
    F.T = d[2];
    F.N = d[3];
    F.row_bytes = d[4];
    F.offset = d[5];
    F.out_c = d[6];
    F.out_b = d[7];
    F.out_u = d[8];
    F.unit = (int)d[9];
    F.tps_log2 = (int)d[10];
  }
  P.ids0 = ids0;
  P.ids1 = ids1;
  P.Bl = Bl;
  const dim3 grid((unsigned)((Bl + GATHER_SAMPLES - 1) / GATHER_SAMPLES), (unsigned)C,
                  (unsigned)nf);
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64) gather_fields_kernel<int64_t><<<grid, GATHER_SAMPLES, 0, s>>>(P);
  else gather_fields_kernel<int32_t><<<grid, GATHER_SAMPLES, 0, s>>>(P);
  return (int)cudaGetLastError();
}

extern "C" int fused_mlp3_smem_bytes(int S, int D1, int D2) {
  return (int)sizeof(float) * mlp3_smem_floats(S, D1, D2);
}

extern "C" int fused_mlp3(const void* x, const void* w0, const void* b0, const void* w1,
                          const void* b1, const void* w2, const void* b2, void* out, int B,
                          int S, int D1, int D2, int A, void* stream) {
  if (B == 0) return 0;
  const int smem = fused_mlp3_smem_bytes(S, D1, D2);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_mlp3_kernel<<<(B + BM - 1) / BM, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w0, (const float*)b0, (const float*)w1,
      (const float*)b1, (const float*)w2, (const float*)b2, (float*)out, B, S, D1, D2, A);
  return (int)cudaGetLastError();
}
