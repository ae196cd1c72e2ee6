// Pieces of the kernels that split an MLP's hidden units over the blocks of
// a thread-block cluster: K11b (kernels.cu, fused_mlp3_kernel), K4's actor,
// K1/K3 and K6/K6′ (fused_rollout.cu: stock_actor_kernel,
// fused_rollout_kernel, offpolicy_rollout_kernel).
//
// Block r of a cluster of c owns `slice(D, c)` consecutive hidden units of
// each layer (rows of W, zero past D).  Its weights sit in shared memory row
// by row, each row ldk(K) floats (16-byte aligned, an odd number of 16-byte
// chunks, so consecutive rows start in different banks); activations are
// (features, M) tiles, M the rows (K11b) or env lanes (K4) of the cluster's
// group; a layer's outputs are pushed to every block of the cluster
// through distributed shared memory (store_cluster).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cm {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;           // threads per block
constexpr int SCRATCH = THREADS * 16;  // floats of split-K partial sums (tile_dense)

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
// hidden units each of c blocks owns, a multiple of 4
__host__ __device__ constexpr int slice(int d, int c) { return round4((d + c - 1) / c); }
// floats a weight row of K inputs takes in shared memory: K rounded up to
// 16 bytes, plus 16 bytes where that count of 16-byte chunks is even
__host__ __device__ constexpr int ldk(int k) { return round4(k) + (round4(k) / 4 % 2 == 0 ? 4 : 0); }
// the same for a row of bf16 values (its stride in bf16 elements): K
// rounded up to 16 bytes (8 values), plus 16 bytes where the count is even
__host__ __device__ constexpr int ldh(int k) {
  return (k + 7) / 8 * 8 + ((k + 7) / 8 % 2 == 0 ? 8 : 0);
}
// Floats of shared memory, in the layouts' 4-byte units, that a weight row
// of K inputs takes (bf: stored as bf16), and that n activation values take.
__host__ __device__ constexpr int wrow(int k, int bf) { return bf ? ldh(k) / 2 : ldk(k); }
__host__ __device__ constexpr int vals(int n, int bf) { return bf ? n / 2 : n; }

// The element type of a kernel's weights and activation tiles: float, or
// bf16 (BF), whose products the kernels widen to f32 and sum in f32.
template <bool BF>
using elem_t = typename std::conditional<BF, __nv_bfloat16, float>::type;
template <bool BF>
__host__ __device__ constexpr int wld(int k) { return BF ? ldh(k) : ldk(k); }

// f32 -> the nearest bf16 (ties to even) -> f32, as jnp's astype(bfloat16)
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// four consecutive values as f32 (16-byte aligned floats, 8-byte aligned bf16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
// one value stored from f32 (rounded to the nearest bf16 for bf16)
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// four values stored from f32 (rounded to the nearest bf16 for bf16)
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[j * ld + k] = W[j0 + j][k0 + k] of a row-major (J, K) matrix for
// j < js and k < round4(ks), zero outside W and past ks.  Consecutive
// threads copy consecutive pieces of a row (coalesced): 16 bytes where the
// rows allow it, else 4.  ASYNC issues cp.async copies (the caller commits
// and waits), else plain loads.
template <bool ASYNC>
__device__ void load_rows(const float* __restrict__ W, int J, int K, int j0, int js, int k0,
                          int ks, float* dst, int ld) {
  const int q = round4(ks) / 4;
  if (((K | k0) & 3) == 0 && ((uintptr_t)W & 15) == 0) {
    for (int i = threadIdx.x; i < js * q; i += blockDim.x) {
      const int j = i / q, k = (i - j * q) * 4;
      float* d = dst + j * ld + k;
      const float* s = W + (size_t)(j0 + j) * K + k0 + k;
      if (j0 + j < J && k0 + k + 4 <= K && k + 4 <= ks) {
        if (ASYNC) cp_async16(d, s);
        else *reinterpret_cast<float4*>(d) = __ldg(reinterpret_cast<const float4*>(s));
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          d[u] = j0 + j < J && k0 + k + u < K && k + u < ks ? __ldg(s + u) : 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < js * 4 * q; i += blockDim.x) {
      const int j = i / (4 * q), k = i - j * 4 * q;
      float* d = dst + j * ld + k;
      const float* s = W + (size_t)(j0 + j) * K + k0 + k;
      if (j0 + j < J && k0 + k < K && k < ks) {
        if (ASYNC) cp_async4(d, s);
        else *d = __ldg(s);
      } else {
        *d = 0.f;
      }
    }
  }
}

// load_rows for a bf16 copy: dst[j * ld + k] = bf16(W[j0 + j][k0 + k]), the
// f32 weights rounded to the nearest bf16 as they are copied (plain loads
// whatever ASYNC says), zero outside W and past ks up to a multiple of 8.
template <bool ASYNC>
__device__ void load_rows(const float* __restrict__ W, int J, int K, int j0, int js, int k0,
                          int ks, __nv_bfloat16* dst, int ld) {
  const int q = (ks + 7) / 8 * 8;
  for (int i = threadIdx.x; i < js * q; i += blockDim.x) {
    const int j = i / q, k = i - j * q;
    dst[j * ld + k] = __float2bfloat16_rn(j0 + j < J && k0 + k < K && k < ks
                                               ? __ldg(W + (size_t)(j0 + j) * K + k0 + k)
                                               : 0.f);
  }
}

// dst[j] = b[j0 + j] for j < js, zero past J
template <bool ASYNC>
__device__ void load_vec(const float* __restrict__ b, int J, int j0, int js, float* dst) {
  for (int j = threadIdx.x; j < js; j += blockDim.x) {
    if (j0 + j < J) {
      if (ASYNC) cp_async4(dst + j, b + j0 + j);
      else dst[j] = __ldg(b + j0 + j);
    } else {
      dst[j] = 0.f;
    }
  }
}

// epi(j, m0, v) with v.x..v.w = sum_{k < K} W[j * ld + k] in[k * M + m] for
// m = m0 .. m0 + 3, for j < J and m0 < M a multiple of 4 (J and K
// multiples of 4, zero-padded), each sum in k order.  A thread
// owns 4 j (J / 4 apart) x 4 m: per 4 k, four 16-byte loads of W rows and
// four of `in` feed 64 FMA; a warp's W loads touch consecutive rows, which
// ldk puts in distinct banks.  With fewer tiles than threads, K is cut into
// KS parts (a power of 2, a thread each, at most ks_max) whose sums meet in
// `scratch` and are added in part order, so a result depends only on (K, J,
// M, ks_max) and never on timing.  No barrier before; with KS > 1 one
// inside.  W and `in` are f32 or bf16 (TW, TI); bf16 values are widened to
// f32, where a product of two bf16 values is exact, and summed in f32.
template <int M, class TW, class TI, class Epi>
__device__ __forceinline__ void tile_dense(const TW* W, int ld, const TI* in, int K, int J,
                                           float* scratch, Epi epi, int ks_max = THREADS) {
  constexpr int MG = M / 4;
  const int J4 = J / 4, tiles = J4 * MG;
  int ks = 1;
  while (2 * ks * tiles <= THREADS && 8 * ks <= K) ks *= 2;
  if (ks > ks_max) ks = ks_max;
  const int kc = round4((K + ks - 1) / ks);
  for (int u = threadIdx.x; u < tiles * ks; u += THREADS) {
    const int tile = u % tiles, part = u / tiles;
    const int m0 = (tile % MG) * 4, jg = tile / MG;
    const int k1 = min(K, (part + 1) * kc);
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 2
    for (int k = part * kc; k < k1; k += 4) {
      float4 w[4], x[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) w[a] = ld4(W + (jg + a * J4) * ld + k);
#pragma unroll
      for (int t = 0; t < 4; ++t) x[t] = ld4(in + (k + t) * M + m0);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float wv[4] = {w[a].x, w[a].y, w[a].z, w[a].w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[a][0] = fmaf(wv[t], x[t].x, acc[a][0]);
          acc[a][1] = fmaf(wv[t], x[t].y, acc[a][1]);
          acc[a][2] = fmaf(wv[t], x[t].z, acc[a][2]);
          acc[a][3] = fmaf(wv[t], x[t].w, acc[a][3]);
        }
      }
    }
    if (ks == 1) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
        epi(jg + a * J4, m0, make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
    } else {
      float* s = scratch + (size_t)part * J * M;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(s + (jg + a * J4) * M + m0) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
  }
  if (ks > 1) {
    __syncthreads();
    for (int o = 4 * threadIdx.x; o < J * M; o += 4 * THREADS) {
      float4 v = *reinterpret_cast<const float4*>(scratch + o);
      for (int p = 1; p < ks; ++p) {
        const float4 w = *reinterpret_cast<const float4*>(scratch + (size_t)p * J * M + o);
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      epi(o / M, o % M, v);
    }
  }
}

// The cluster barrier split in two: a block may store into another's
// shared memory only once that block has started, so a kernel arrives as it
// begins and waits just before its first remote store, with its own work in
// between.  Each thread calls both, once, before any cluster.sync().
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Store v at offset i (a multiple of 4) of `base` in each of the cluster's
// c blocks (the same offset of their shared memory), its own included: a
// layer's outputs are pushed to every block that reads them, and each reads
// its own copy after the next cluster barrier, so no block waits on a
// remote load.
// A bf16 tile takes the values rounded to the nearest bf16.
template <class T>
__device__ __forceinline__ void store_cluster(cg::cluster_group& cluster, int c, T* base, int i,
                                              float4 v) {
  if (c == 1) {
    st4(base + i, v);
    return;
  }
  for (int q = 0; q < c; ++q) st4(cluster.map_shared_rank(base + i, q), v);
}


// SM count of the current device, read once per device
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

// A launch configuration of `blocks` blocks in clusters of c.
inline cudaLaunchConfig_t cluster_config(int blocks, int c, int smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of c blocks with `smem` bytes each that the card holds at once
// (cudaOccupancyMaxActiveClusters, which knows how clusters pack into the
// GPCs); the kernel's shared-memory attribute must allow `smem`.  0 on an
// error.
template <class Kernel>
int active_clusters(Kernel kernel, int c, int smem) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(c, c, smem, nullptr, attr);
  int active = 0;
  if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) != cudaSuccess) return 0;
  return active;
}

// Launch `kernel` as clusters of c blocks of THREADS threads.
template <class Kernel, class... Args>
cudaError_t launch_clusters(Kernel kernel, int blocks, int c, int smem, cudaStream_t stream,
                            Args... args) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(blocks, c, smem, stream, attr);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace cm
