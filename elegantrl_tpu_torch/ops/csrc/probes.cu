// The seven Mosaic lowering probes of scripts/probe_mosaic_ops.py, for
// Hopper.  Each probe there is a minimal Pallas kernel that checked whether
// Mosaic lowers one op the fused stock body needed; here each is a small
// kernel that computes the same function from the same inputs:
//
//   P1 probe_sublane_dynslice_value (:41, pallas_call :49): out (8, L) =
//      sum(tab[day, :]) with tab (T, R) taken whole as a value;
//   P2 probe_sublane_dynslice_ref (:58, :65): the same, the row read from
//      the ref;
//   P3 probe_transpose_1xN (:74, :81): x (1, R) -> out (R, L), out[r, :] =
//      x[0, r];
//   P4 probe_dynslice_then_transpose (:89, :98): out (R, L), out[r, :] =
//      tab[day, r];
//   P5 probe_scalar_from_vmem (:107, :115): day = i[0, 0] of an int32 (1, L)
//      vector; out (8, L) = sum(tab[day, :]);
//   P6 probe_lane_dynslice_ref (:124, :131): tab (R, T); out (R, L),
//      out[r, :] = tab[r, day];
//   P7 probe_fori_scalar_carry (:140, :152): out (R, L), out[r, :] =
//      sum_{t < steps} tab[day_t, r], day_0 = 0, day_{t+1} = (day_t + 1) % T.
//
// Bound on this card: bytes, a few KB read and written, well under a
// microsecond; launch latency sets the time in practice.
//
// Design.  On the TPU each probe tested a Mosaic lowering: a dynamic slice
// along sublanes or lanes, a (1, N) -> (N, 1) relayout, or a scalar read
// from VMEM into a dynamic index.  On Hopper a dynamic index into global or
// shared memory is plain addressing and no relayout exists, so each kernel
// reads its index on the device (no host sync) and writes its output
// directly, one thread per output element, one block of 128 threads per
// 128 elements.  P1 stages the whole table in shared memory first (the
// "value" form), P2 reads the row from global memory (the "ref" form).  The
// sums run in row order, element by element, in every thread.  The port's
// stock body (fused_rollout.cu, StockBody) does these ops inside the
// rollout kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ int wrap(int day, int T) {
  day %= T;
  return day < 0 ? day + T : day;
}

__device__ __forceinline__ float row_sum(const float* row, int R) {
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += row[r];
  return s;
}

// P1: the whole (T, R) table in shared memory, then the row sum.
__global__ void p1_kernel(const float* __restrict__ tab, const int* __restrict__ day,
                          float* __restrict__ out, int T, int R, int n_out) {
  extern __shared__ float s_tab[];
  for (int i = threadIdx.x; i < T * R; i += blockDim.x) s_tab[i] = tab[i];
  __syncthreads();
  const int d = wrap(day[0], T);
  const float v = row_sum(s_tab + d * R, R);
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o < n_out) out[o] = v;
}

// P2 and P5: the row sum read from global memory; the day from an int32
// scalar (P2) or the first element of an int32 vector (P5): both are a
// load from device memory here.
__global__ void row_sum_kernel(const float* __restrict__ tab, const int* __restrict__ day,
                               float* __restrict__ out, int T, int R, int n_out) {
  const int d = wrap(day[0], T);
  const float v = row_sum(tab + (size_t)d * R, R);
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o < n_out) out[o] = v;
}

// P3 (src = x, day = null) and P4 (src = tab, day): out[r, l] = src[day, r].
__global__ void row_to_column_kernel(const float* __restrict__ src,
                                     const int* __restrict__ day, float* __restrict__ out,
                                     int T, int R, int L) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= R * L) return;
  const int d = day == nullptr ? 0 : wrap(day[0], T);
  out[o] = src[(size_t)d * R + o / L];
}

// P6: tab (R, T), out[r, l] = tab[r, day].
__global__ void column_kernel(const float* __restrict__ tab, const int* __restrict__ day,
                              float* __restrict__ out, int T, int R, int L) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= R * L) return;
  out[o] = tab[(size_t)(o / L) * T + wrap(day[0], T)];
}

// P7: the day carried through a loop of `steps`, out[r, l] = sum_t tab[day_t, r].
__global__ void carry_kernel(const float* __restrict__ tab, float* __restrict__ out, int T,
                             int R, int L, int steps) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= R * L) return;
  const int r = o / L;
  float acc = 0.f;
  int d = 0;
  for (int t = 0; t < steps; ++t) {
    acc += tab[(size_t)d * R + r];
    d = (d + 1) % T;
  }
  out[o] = acc;
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// which: 1 ... 7 (P1 ... P7).  tab is (T, R) (P6: (R, T); P3: x, (1, R));
// idx the int32 day (P1, P2, P4, P6) or the int32 vector whose first
// element is the day (P5), null for P3 and P7; out is (8, L) for P1, P2, P5
// and (R, L) otherwise.  Returns cudaGetLastError() after the launch.
extern "C" int mosaic_probe(int which, const void* tab, const void* idx, void* out, int T,
                            int R, int L, int steps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* tb = (const float*)tab;
  const int* d = (const int*)idx;
  float* o = (float*)out;
  const int n_sum = 8 * L, n_col = R * L;
  switch (which) {
    case 1: {
      const int smem = (int)sizeof(float) * T * R;
      if (smem > 48 * 1024) {
        cudaError_t err =
            cudaFuncSetAttribute(p1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
      }
      p1_kernel<<<blocks_for(n_sum), THREADS, smem, s>>>(tb, d, o, T, R, n_sum);
      break;
    }
    case 2:
    case 5:
      row_sum_kernel<<<blocks_for(n_sum), THREADS, 0, s>>>(tb, d, o, T, R, n_sum);
      break;
    case 3:
      row_to_column_kernel<<<blocks_for(n_col), THREADS, 0, s>>>(tb, nullptr, o, 1, R, L);
      break;
    case 4:
      row_to_column_kernel<<<blocks_for(n_col), THREADS, 0, s>>>(tb, d, o, T, R, L);
      break;
    case 6:
      column_kernel<<<blocks_for(n_col), THREADS, 0, s>>>(tb, d, o, T, R, L);
      break;
    case 7:
      carry_kernel<<<blocks_for(n_col), THREADS, 0, s>>>(tb, o, T, R, L, steps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
