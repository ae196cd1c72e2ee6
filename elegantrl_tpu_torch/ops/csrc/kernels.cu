// The three kernels of elegantrl_tpu/ops/pallas_kernels.py, for Hopper:
//
// 1. gae_vtrace_kernel (K10) replaces gae_vtrace_pallas (:123; kernel
//    _gae_kernel :99, pallas_call :146): the reverse V-trace recursion
//      m = undone * gamma
//      adv[t] = ((r[t] + m * next_v) - v[t]) + (m * lam) * adv[t+1]
//      next_v = v[t], starting from next_value and adv = 0,
//    with, folded into the same pass (the PPO advantage step around it,
//    elegantrl_tpu/agents/ppo.py:update, ops/gae.py), the truncation
//    bootstrap r = r + (1 - unmask) v, undone = undone * unmask before it
//    and reward_sums = adv + v after it.
//    Bound on this card: bytes (r, u, unmask, v read and adv, reward_sums
//    written once, 24 B a cell: 1.88 us at 4096 envs x 64 steps; the
//    recursion alone would move 16 B a cell).  The first design (one thread per env column
//    walking t = H-1 ... 0 with three dependent global loads a step) ran 16
//    blocks at 4096 envs and one at 64, with each step's loads in the
//    recursion's serial chain.  Design: a block owns GAE_COLS = 32 env
//    columns; all its warps stage GAE_ROWS time rows of the inputs into
//    shared memory as 128-byte rows with cp.async, double-buffered from the
//    last rows down, so the next stage lands while warp 0 walks the
//    recursion over this one from shared memory (a lane a column); warps
//    1-7 meanwhile store the previous stage's outputs, coalesced.  128
//    blocks at 4096 envs.  Every operation is an explicit round-to-nearest
//    intrinsic in the plain composition's order (nvcc would contract a*b+c
//    into an FMA), so the result is bitwise the plain version's
//    (ops/kernels.py:vtrace_advantages_reference).
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
//    every B this slice runs; the weights are read once.  At the rollouts'
//    B = 64 the work is 2.3-8.8 MFLOP against 70-274 KB of weights resident
//    in L2, so what sets the time is how many SMs share it and how long a
//    chain of dependent steps each runs, not the FLOP.  Design (after a
//    design of 32-row blocks that streamed every W through one shared tile:
//    two blocks and 14-44 tile steps at B = 64): one thread-block cluster of
//    c blocks per RM rows of x (RM 16, 32 or 64).  Block r owns 1/c of each
//    hidden layer (rows of W0, b0, W1, b1; the matching columns of W2), so
//    its weights sit in shared memory for the whole call: they are copied
//    row by row with 16-byte cp.async at the start, W0 first, before x is
//    read, so their latency is paid once and the rest overlaps the first
//    layer.  Each block pushes its rows of the first hidden layer into every
//    block of the cluster (distributed shared memory stores), so after a
//    cluster barrier layer 1 reads the whole layer locally; its part of the
//    output layer's sums (rows x A) goes to the block that owns those rows,
//    which adds the parts in rank order, so two runs are bitwise equal.
//    The host picks (RM, c) from B: the smallest cluster, then the largest
//    RM, whose grid fills the card (B = 1000: RM 16, c 2; B = 16,384: RM
//    64, c 1), or at a small B the layout with the most blocks (B = 64: RM
//    16, c 8, 32 blocks); scripts/torch_cluster_kernels.py times every
//    layout against this choice.  Sums run in
//    k order per output, split over a power-of-2 number of threads where a
//    slice has fewer output tiles than threads (cluster_mlp.cuh:tile_dense).
//    tanhf is the accurate one: the library is built without
//    --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_mlp.cuh"
#include "mlp_grad.cuh"

namespace {

// ---------------------------------------------------------------- K10 GAE

constexpr int GAE_COLS = 32;     // env columns a block (a warp's lanes)
constexpr int GAE_ROWS = 32;     // time rows a stage
constexpr int GAE_THREADS = 256;

// inputs: 0 rewards, 1 undones, 2 unmasks, 3 values; outputs: 0 adv,
// 1 reward_sums.  vec: 16-byte copies (N % 4 == 0 and
// every pointer 16-byte aligned).
__global__ void __launch_bounds__(GAE_THREADS)
gae_vtrace_kernel(const float* __restrict__ r, const float* __restrict__ u,
                  const float* __restrict__ um, const float* __restrict__ v,
                  const float* __restrict__ nv0, float* __restrict__ adv,
                  float* __restrict__ rs, int H, int N, float gamma, float lam, int vec) {
  __shared__ __align__(16) float in[2][4][GAE_ROWS][GAE_COLS];
  __shared__ __align__(16) float out[2][2][GAE_ROWS][GAE_COLS];
  const int n0 = blockIdx.x * GAE_COLS, cols = min(GAE_COLS, N - n0);
  const int stages = (H + GAE_ROWS - 1) / GAE_ROWS;
  // stage k holds rows t0 .. t0 + len - 1, t0 = max(H - (k + 1) GAE_ROWS, 0)
  auto rows = [&](int k, int& t0) {
    const int t1 = H - k * GAE_ROWS;
    t0 = max(t1 - GAE_ROWS, 0);
    return t1 - t0;
  };
  auto stage_in = [&](int k) {  // every thread: its share of stage k's copies
    int t0;
    const int len = rows(k, t0), per = len * (GAE_COLS / 4);
    for (int i = threadIdx.x; i < 4 * per; i += GAE_THREADS) {
      const int f = i / per, row = (i - f * per) / (GAE_COLS / 4), q = (i % (GAE_COLS / 4)) * 4;
      const float* src = f == 0 ? r : f == 1 ? u : f == 2 ? um : v;
      const float* g = src + (size_t)(t0 + row) * N + n0 + q;
      float* d = &in[k & 1][f][row][q];
      if (vec && q + 4 <= cols) {
        cm::cp_async16(d, g);
      } else {
        for (int x = 0; x < 4 && q + x < cols; ++x) cm::cp_async4(d + x, g + x);
      }
    }
    cm::cp_async_commit();
  };
  auto store_out = [&](int k, int first) {  // threads from `first` on: stage k's outputs
    int t0;
    const int len = rows(k, t0), per = len * (GAE_COLS / 4);
    for (int i = (int)threadIdx.x - first; i < 2 * per; i += GAE_THREADS - first) {
      if (i < 0) return;
      const int f = i / per, row = (i - f * per) / (GAE_COLS / 4), q = (i % (GAE_COLS / 4)) * 4;
      float* g = (f == 0 ? adv : rs) + (size_t)(t0 + row) * N + n0 + q;
      const float* s = &out[k & 1][f][row][q];
      if (vec && q + 4 <= cols) {
        *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(s);
      } else {
        for (int x = 0; x < 4 && q + x < cols; ++x) g[x] = s[x];
      }
    }
  };
  const int e = threadIdx.x;  // warp 0: the column of a lane
  float next_v = 0.f, a = 0.f;
  if (e < cols) next_v = nv0[n0 + e];
  stage_in(0);
  for (int k = 0; k < stages; ++k) {
    cm::cp_async_wait<0>();
    __syncthreads();  // stage k landed; stage k - 1 walked; stage k - 2 stored
    if (k + 1 < stages) stage_in(k + 1);  // into the buffer stage k - 1 left
    if (threadIdx.x < 32) {
      int t0;
      const int len = rows(k, t0);
      if (e < cols) {
        const float(*x)[GAE_ROWS][GAE_COLS] = in[k & 1];
        for (int row = len - 1; row >= 0; --row) {
          const float vt = x[3][row][e], mk = x[2][row][e];
          // the truncation bootstrap, then the recursion
          const float rr = __fadd_rn(x[0][row][e], __fmul_rn(__fsub_rn(1.0f, mk), vt));
          const float uu = __fmul_rn(x[1][row][e], mk);
          const float m = __fmul_rn(uu, gamma);
          a = __fadd_rn(__fsub_rn(__fadd_rn(rr, __fmul_rn(m, next_v)), vt),
                        __fmul_rn(__fmul_rn(m, lam), a));
          out[k & 1][0][row][e] = a;
          out[k & 1][1][row][e] = __fadd_rn(a, vt);
          next_v = vt;
        }
      }
    } else if (k > 0) {
      store_out(k - 1, 32);  // warps 1-7, meanwhile
    }
  }
  __syncthreads();
  if (stages > 0) store_out(stages - 1, 0);
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

// Shared memory of one block (floats): the block's weight slices, row by
// row (W0's and W1's rows, W2's columns: cluster_mlp.cuh), the biases, then
// x transposed (round4(S), RM) whose space the block's rows of the second
// hidden layer (js2, RM) take over, the whole first hidden layer (c js1,
// RM), every block's part of this block's RM / c output rows (c,
// round4(A), RM / c) and the split-K scratch.
struct Mlp3Layout {
  int js1, js2, ap, s4, d1c, w0t, b0, w1t, b1, w2t, b2, xt, h0t, part, scratch, floats;
  __host__ __device__ Mlp3Layout(int S, int D1, int D2, int A, int RM, int c) {
    js1 = cm::slice(D1, c);
    js2 = cm::slice(D2, c);
    ap = cm::round4(A);
    s4 = cm::round4(S);
    d1c = c * js1;
    int o = 0;
    w0t = o; o += js1 * cm::ldk(S);
    b0 = o; o += js1;
    w1t = o; o += js2 * cm::ldk(d1c);
    b1 = o; o += js2;
    w2t = o; o += ap * cm::ldk(js2);
    b2 = o; o += ap;
    xt = o; o += (s4 > js2 ? s4 : js2) * RM;
    h0t = o; o += d1c * RM;
    part = o; o += ap * RM;
    scratch = o; o += cm::SCRATCH;
    floats = o;
  }
};

constexpr int MLP3_SMEM_LIMIT = 232448;        // bytes of shared memory a Hopper block can hold
constexpr int MLP3_CLUSTERS[4] = {1, 2, 4, 8};   // cluster sizes, smallest first
constexpr int MLP3_ROWS[3] = {64, 32, 16};       // rows of x per cluster, largest first

// One cluster of c blocks per RM rows of x; block r computes its slice of
// each layer for all RM rows.
template <int RM>
__global__ void __launch_bounds__(cm::THREADS, 2)
fused_mlp3_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                  const float* __restrict__ b0, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out, int B, int S, int D1,
                  int D2, int A) {
  cm::cg::cluster_group cluster = cm::cg::this_cluster();
  const int c = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const Mlp3Layout L(S, D1, D2, A, RM, c);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float *w0t = sm + L.w0t, *b0s = sm + L.b0, *w1t = sm + L.w1t, *b1s = sm + L.b1;
  float *w2t = sm + L.w2t, *b2s = sm + L.b2, *xt = sm + L.xt, *h0t = sm + L.h0t;
  float *part = sm + L.part, *scratch = sm + L.scratch;
  float* h1t = xt;  // x is dead once the first layer is done
  const int js1 = L.js1, js2 = L.js2, ap = L.ap;
  cm::cluster_arrive();  // this block has started

  // the weights, asynchronously: the first layer's, then the rest
  cm::load_rows<true>(w0, D1, S, r * js1, js1, 0, S, w0t, cm::ldk(S));
  cm::load_vec<true>(b0, D1, r * js1, js1, b0s);
  cm::cp_async_commit();
  cm::load_rows<true>(w1, D2, D1, r * js2, js2, 0, L.d1c, w1t, cm::ldk(L.d1c));
  cm::load_vec<true>(b1, D2, r * js2, js2, b1s);
  cm::load_rows<true>(w2, A, D2, 0, ap, r * js2, js2, w2t, cm::ldk(js2));
  cm::load_vec<true>(b2, A, 0, ap, b2s);
  cm::cp_async_commit();
  // the group's rows of x, transposed, zero past B and past S
  const int m0 = (blockIdx.x / c) * RM;
  const int rows = min(RM, B - m0);
  for (int i = threadIdx.x; i < RM * L.s4; i += blockDim.x) {
    const int m = i / L.s4, k = i - m * L.s4;
    xt[k * RM + m] = m < rows && k < S ? __ldg(x + (size_t)(m0 + m) * S + k) : 0.f;
  }
  cm::cp_async_wait<1>();
  __syncthreads();
  cm::cluster_wait();  // every block has started: the layer's rows may be pushed
  cm::tile_dense<RM>(w0t, cm::ldk(S), xt, L.s4, js1, scratch, [&](int j, int m4, float4 v) {
    const float b = b0s[j];
    cm::store_cluster(cluster, c, h0t, (r * js1 + j) * RM + m4,
                      make_float4(mlp::gelu_tanh(v.x + b), mlp::gelu_tanh(v.y + b),
                                  mlp::gelu_tanh(v.z + b), mlp::gelu_tanh(v.w + b)));
  });
  cluster.sync();  // every block's rows of h0, in every block
  cm::cp_async_wait<0>();
  __syncthreads();
  cm::tile_dense<RM>(w1t, cm::ldk(L.d1c), h0t, L.d1c, js2, scratch, [&](int j, int m4, float4 v) {
    const float b = b1s[j];
    *reinterpret_cast<float4*>(h1t + j * RM + m4) =
        make_float4(mlp::gelu_tanh(v.x + b), mlp::gelu_tanh(v.y + b), mlp::gelu_tanh(v.z + b),
                    mlp::gelu_tanh(v.w + b));
  });
  __syncthreads();
  // this block's part of the output, pushed to the block that owns the row:
  // block q owns rows q * per ... and holds every block's part of them
  const int per = RM / c;
  cm::tile_dense<RM>(w2t, cm::ldk(js2), h1t, js2, ap, scratch, [&](int j, int m4, float4 v) {
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float* dst = part + (r * ap + j) * per + (m4 + b) % per;
      if (c == 1) *dst = vs[b];
      else *cluster.map_shared_rank(dst, (m4 + b) / per) = vs[b];
    }
  });
  cluster.sync();  // every block's parts of this block's rows
  // this block's rows of the output: the parts in rank order, then b2
  for (int i = threadIdx.x; i < per * A; i += blockDim.x) {
    const int ml = i / A, a = i % A;
    if (r * per + ml >= rows) continue;
    float v = part[a * per + ml];
    for (int q = 1; q < c; ++q) v += part[(q * ap + a) * per + ml];
    out[(size_t)(m0 + r * per + ml) * A + a] = v + b2s[a];
  }
}

int mlp3_smem(int S, int D1, int D2, int A, int RM, int c) {
  return (int)sizeof(float) * Mlp3Layout(S, D1, D2, A, RM, c).floats;
}

// The launch for B rows: the first layout, by cluster size (1, 2, 4, 8:
// fewer cluster barriers and row copies first) and then RM (64, 32, 16:
// fewer weight copies first), whose shared memory fits and whose grid fills
// the card (at least 15/16 of its SMs); where none does (a small B), the
// layout with the most blocks, then the fewest rows x hidden units a block.
// rm = 0 when no layout fits.
void mlp3_config(int B, int S, int D1, int D2, int A, int sms, int& rm, int& c) {
  rm = 0;
  c = 0;
  long long most = -1;
  int least = 1 << 30;
  for (int cc : MLP3_CLUSTERS)
    for (int RM : MLP3_ROWS) {
      if (mlp3_smem(S, D1, D2, A, RM, cc) > MLP3_SMEM_LIMIT) continue;
      const long long blocks = (long long)((B + RM - 1) / RM) * cc;
      if (16 * blocks >= 15LL * sms) {
        rm = RM;
        c = cc;
        return;
      }
      if (blocks > most || (blocks == most && RM / cc < least)) {
        most = blocks;
        least = RM / cc;
        rm = RM;
        c = cc;
      }
    }
}

template <int RM>
int mlp3_launch(const void* x, const void* w0, const void* b0, const void* w1, const void* b1,
                const void* w2, const void* b2, void* out, int B, int S, int D1, int D2, int A,
                int c, cudaStream_t stream) {
  static bool attr_set = false;  // the attribute is set once, to a block's whole limit
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_mlp3_kernel<RM>, cudaFuncAttributeMaxDynamicSharedMemorySize, MLP3_SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int smem = mlp3_smem(S, D1, D2, A, RM, c);
  const int blocks = (B + RM - 1) / RM * c;
  return (int)cm::launch_clusters(fused_mlp3_kernel<RM>, blocks, c, smem, stream,
                                  (const float*)x, (const float*)w0, (const float*)b0,
                                  (const float*)w1, (const float*)b1, (const float*)w2,
                                  (const float*)b2, (float*)out, B, S, D1, D2, A);
}

}  // namespace

extern "C" int gae_vtrace(const void* r, const void* u, const void* um, const void* v,
                          const void* nv, void* adv, void* rs, int H, int N, float gamma,
                          float lam, void* stream) {
  if (H == 0 || N == 0) return 0;
  const void* ptrs[] = {r, u, um, v, adv, rs};
  int vec = N % 4 == 0;
  for (const void* q : ptrs) vec = vec && ((uintptr_t)q & 15) == 0;
  gae_vtrace_kernel<<<(N + GAE_COLS - 1) / GAE_COLS, GAE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)u, (const float*)um, (const float*)v, (const float*)nv,
      (float*)adv, (float*)rs, H, N, gamma, lam, vec);
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

// Shared memory of one K11b block for RM rows a cluster and clusters of c.
extern "C" int fused_mlp3_smem_bytes(int S, int D1, int D2, int A, int RM, int c) {
  return mlp3_smem(S, D1, D2, A, RM, c);
}

// The (RM, c) the launch takes for B rows on this card, as RM * 16 + c;
// 0 when no layout fits.
extern "C" int fused_mlp3_config(int B, int S, int D1, int D2, int A) {
  int rm, c;
  mlp3_config(B, S, D1, D2, A, cm::sm_count(), rm, c);
  return rm * 16 + c;
}

// rm and c pick the layout (RM 64, 32 or 16 rows a cluster of c = 1, 2, 4 or
// 8 blocks; its shared memory must fit); rm = 0 takes mlp3_config's choice.
extern "C" int fused_mlp3(const void* x, const void* w0, const void* b0, const void* w1,
                          const void* b1, const void* w2, const void* b2, void* out, int B,
                          int S, int D1, int D2, int A, int rm, int c, void* stream) {
  if (B == 0) return 0;
  if (rm == 0) mlp3_config(B, S, D1, D2, A, cm::sm_count(), rm, c);
  else if ((c != 1 && c != 2 && c != 4 && c != 8) || mlp3_smem(S, D1, D2, A, rm, c) > MLP3_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rm) {
    case 64: return mlp3_launch<64>(x, w0, b0, w1, b1, w2, b2, out, B, S, D1, D2, A, c, st);
    case 32: return mlp3_launch<32>(x, w0, b0, w1, b1, w2, b2, out, B, S, D1, D2, A, c, st);
    case 16: return mlp3_launch<16>(x, w0, b0, w1, b1, w2, b2, out, B, S, D1, D2, A, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
