// Spatial softmax + soft-argmax decode of NHWK logits: (B, H, W, K) float32
// or bfloat16 -> (B, K, 2) float32 [u, v] in heatmap pixels.
//
// Replaces the TPU kernel ops/pallas/decode_kernel.py::fused_softmax_decode
// (its body _decode_kernel) of the JAX package.  For every sample b and joint
// k, with x_p = T * logits[b, p / W, p % W, k] over the H*W pixels p:
//
//   m = max_p x_p,   e_p = exp(x_p - m),
//   u = sum_p e_p * (p % W) / sum_p e_p,   v = sum_p e_p * (p / W) / sum_p e_p
//
// i.e. soft_argmax(spatial_softmax(logits, T)) without writing the
// probabilities.  The TPU kernel transposes to (B, K, HW) first and pads B to
// 8 and K to 128 lanes; none of that is needed here: the logits are read in
// place, in their NHWK layout.
//
// Bound: the bytes of the logits, read once (B*H*W*K*2 = 5.5 MB at B=32 for
// 64x64x21 bfloat16, 1.6 us at 3.35 TB/s); the arithmetic (one expf and a
// few FMAs per element) is far below the card's float32 rate.  A design of
// one block per sample with one online-softmax chain per thread was bound by
// that chain (a load, an expf and a rescale branch per element, ~171 deep)
// and filled 32 of 132 SMs at B=32.  This one splits the plane:
//
// - Grid (S, B): sample b's plane splits into S contiguous pixel ranges, one
//   block each (S = 8 where the plane has 8 pixels: 1024 blocks at B=128);
//   the S blocks of a sample form a thread-block cluster.
// - A block copies its range into shared memory once (16-byte loads, scalar
//   head and tail where the range's bytes do not start or end on 16), in
//   pieces of at most 32 KB (with the pixels' (u, v)).
// - Per piece, warp w takes the joints k = w, w + 8, ...; per joint two
//   passes over shared memory, each lane over 4 pixels at a time (their
//   loads and exps independent): first the exact max m, then sum e, sum e*u
//   and sum e*v with e = exp(x - m) and (u, v) from a per-piece table, no
//   rescale in the chain; warp shuffles reduce the lanes, and one rescale
//   merges the piece into the joint's state in shared memory.
// - The cluster combines its blocks' states per joint through distributed
//   shared memory (block r the joints k % S == r), one rescale per block,
//   and divides once.
//
// The arithmetic is IEEE: expf (not __expf) and a true division.  A plane of
// equal logits decodes to exactly ((W-1)/2, (H-1)/2) (every e is 1 and every
// rescale 1, the sums exact integers); a plane with one logit far above the
// rest decodes to exactly that pixel (every other e and the other blocks'
// rescale factors underflow to 0).  A -inf logit adds 0; an all -inf plane
// gives NaN and a NaN logit makes its joint NaN, as the plain softmax does.
// The temperature is read through a device pointer (the model's
// trainable_temp) or passed by value, so the launch never waits for the
// device.  Where a gradient is wanted, the forward also writes each plane's
// softmax state (m, s = sum e) through a nullable pointer, for the backward
// below; the inference launch passes null and writes nothing more.
//
// The backward (softmax_decode_bwd_kernel) replaces no TPU kernel: the JAX
// package differentiates its plain decode and its Pallas kernel has no VJP.
// The port decodes the train forward of the 3D nets through the kernel, so it
// needs one.  Given the upstream gradient (g_u, g_v) per (b, k), with
// p = exp(T x - m) / s and (E_u, E_v) the forward's output:
//
//   g_z = p * (g_u (u - E_u) + g_v (v - E_v)),   dx = T g_z,
//   dT  = sum over b, k and pixels of x g_z.
//
// Bound: the bytes of x read once and of dx written once (2 x 5.5 MB at B=32
// for 64x64x21 bfloat16); one expf and a few FMAs per element.  Design: an
// elementwise pass over x in its NHWK layout, 16 bytes a thread at a time
// (8 bfloat16 or 4 float32; the wrapper copies an x that is not 16-byte
// aligned, and dx is a fresh allocation),
// a grid-stride loop over a grid whose size depends on the element count
// only; (b, k) walks along the group (k + 1, wrapping into the next pixel),
// and the per-plane (m, s, E, g) come from the small (B, K, 2) arrays
// through the read-only cache.  dT, where asked for: each block reduces its
// threads' sums in a fixed tree and writes a partial; the last block to
// finish (an integer atomic on a counter the wrapper zeroes) adds the
// partials in index order.  No float atomics: two runs give bit-equal
// gradients.

#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "conv_mainloop.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;       // 1024 threads: 64 registers a thread
constexpr int kUnroll = 4;            // pixels a lane has in flight
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
constexpr int kMaxSplit = 8;          // the portable cluster size

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ inline int state_bytes(int K) { return (K * 16 + 127) / 128 * 128; }
// the per-pixel (u, v) table of a piece, whole 16-byte units
__host__ __device__ inline int uv_bytes(int piece) { return (piece * 8 + 15) / 16 * 16; }

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) softmax_decode_kernel(
    const T* __restrict__ logits, const float* __restrict__ temp_ptr, float temp_value,
    float* __restrict__ out, float* __restrict__ stats, int HW, int W, int K, int range,
    int piece) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* state = reinterpret_cast<float4*>(smem);          // per joint (m, s, su, sv)
  float2* uv = reinterpret_cast<float2*>(smem + state_bytes(K));   // per pixel of a piece
  unsigned char* buf = smem + state_bytes(K) + uv_bytes(piece);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = (int)cluster.block_rank(), S = (int)cluster.num_blocks(), b = blockIdx.y;
  const float temp = temp_ptr != nullptr ? *temp_ptr : temp_value;
  const int p_begin = rank * range, p_end = min(HW, p_begin + range);
  for (int k = tid; k < K; k += kThreads) state[k] = make_float4(-INFINITY, 0.0f, 0.0f, 0.0f);

  for (int p0 = p_begin; p0 < p_end; p0 += piece) {
    const int np = min(piece, p_end - p0);
    __syncthreads();   // the previous piece is read (and the states are set)
    // the piece's np * K logits, at the same offset from a 16-byte boundary
    // in shared memory as in device memory
    const T* src = logits + ((size_t)b * HW + p0) * K;
    const int n = np * K;
    const int shift = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    T* x = reinterpret_cast<T*>(buf + shift);
    const int head = min(n, ((16 - shift) & 15) / (int)sizeof(T));
    const int nv = (n - head) * (int)sizeof(T) / 16;
    const int tail = head + nv * 16 / (int)sizeof(T);
    for (int i = tid; i < head; i += kThreads) x[i] = src[i];
    const uint4* src16 = reinterpret_cast<const uint4*>(src + head);
    uint4* dst16 = reinterpret_cast<uint4*>(x + head);
    for (int i = tid; i < nv; i += kThreads) dst16[i] = __ldg(src16 + i);
    for (int i = tail + tid; i < n; i += kThreads) x[i] = src[i];
    // each pixel's (u, v), shared by the K joints
    for (int q = tid; q < np; q += kThreads) {
      const int p = p0 + q, row = p / W;
      uv[q] = make_float2((float)(p - row * W), (float)row);
    }
    __syncthreads();

    for (int k = warp; k < K; k += kWarps) {
      // each lane kUnroll pixels at once, 32 apart: independent loads, exps
      // and sums in flight
      float mu[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mu[u] = -INFINITY;
      for (int q0 = lane; q0 < np; q0 += 32 * kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + 32 * u;
          if (q < np) mu[u] = hrnet::max_nan(mu[u], to_float(x[q * K + k]) * temp);
        }
      }
      float m = mu[0];
#pragma unroll
      for (int u = 1; u < kUnroll; ++u) m = hrnet::max_nan(m, mu[u]);
      for (int o = 16; o > 0; o /= 2) m = hrnet::max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
      // a range of -inf logits (m = -inf) adds nothing; else e = exp(x - m)
      // is 0 for x = -inf, and a NaN x makes m and every e NaN
      float su_[kUnroll][3];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) su_[u][0] = su_[u][1] = su_[u][2] = 0.0f;
      if (m != -INFINITY) {
        for (int q0 = lane; q0 < np; q0 += 32 * kUnroll) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int q = q0 + 32 * u;
            if (q < np) {
              const float e = expf(to_float(x[q * K + k]) * temp - m);
              const float2 c = uv[q];
              su_[u][0] += e;
              su_[u][1] += e * c.x;
              su_[u][2] += e * c.y;
            }
          }
        }
      }
      float s = su_[0][0], su = su_[0][1], sv = su_[0][2];
#pragma unroll
      for (int u = 1; u < kUnroll; ++u) {
        s += su_[u][0];
        su += su_[u][1];
        sv += su_[u][2];
      }
      for (int o = 16; o > 0; o /= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        su += __shfl_xor_sync(0xffffffffu, su, o);
        sv += __shfl_xor_sync(0xffffffffu, sv, o);
      }
      if (lane == 0) hrnet::merge_softmax(state[k], m, s, su, sv);
    }
  }

  // the cluster's ranges combined per joint; block r takes joints k % S == r
  cluster.sync();
  for (int k = rank + tid * S; k < K; k += kThreads * S) {
    float4 P = make_float4(-INFINITY, 0.0f, 0.0f, 0.0f);
    for (int r = 0; r < S; ++r) {
      const float4 q = cluster.map_shared_rank(state, r)[k];
      hrnet::merge_softmax(P, q.x, q.y, q.z, q.w);
    }
    float* o = out + ((size_t)b * K + k) * 2;
    o[0] = P.z / P.y;
    o[1] = P.w / P.y;
    if (stats != nullptr) {
      stats[((size_t)b * K + k) * 2] = P.x;
      stats[((size_t)b * K + k) * 2 + 1] = P.y;
    }
  }
  cluster.sync();   // no block leaves while the others read its states
}

template <typename T>
int launch(const void* logits, const float* temp, float temp_value, void* out, float* stats,
           int B, int HW, int W, int K, int splits, int range, int piece, int smem,
           cudaStream_t stream) {
  static int raised[hrnet::kMaxDevices] = {};
  cudaError_t err = hrnet::raise_smem(softmax_decode_kernel<T>, smem, raised);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, softmax_decode_kernel<T>, static_cast<const T*>(logits), temp,
                           temp_value, static_cast<float*>(out), stats, HW, W, K, range,
                           piece);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- the backward ----------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdMaxBlocks = 1024;   // fixed: the dT partials do not depend on the card

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ void from_float(float v, float& d) { d = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16& d) { d = __float2bfloat16(v); }

// N consecutive elements starting at element e of a (B*HW, K) row-major x:
// dx for each, and x * g_z summed into acc
template <typename T, int N>
__device__ __forceinline__ void bwd_group(const T (&xv)[N], T (&dv)[N], long long e, int HW,
                                          int W, int K, float temp,
                                          const float2* __restrict__ stats,
                                          const float2* __restrict__ coords,
                                          const float2* __restrict__ grad, float& acc) {
  const long long row = e / K;
  int k = (int)(e - row * K);
  int b = (int)(row / HW);
  int p = (int)(row - (long long)b * HW);
  float u = (float)(p % W), v = (float)(p / W);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int plane = b * K + k;
    const float2 ms = __ldg(stats + plane), c = __ldg(coords + plane), g = __ldg(grad + plane);
    const float x = to_float(xv[j]);
    const float prob = expf(x * temp - ms.x) / ms.y;
    const float gz = prob * (g.x * (u - c.x) + g.y * (v - c.y));
    from_float(temp * gz, dv[j]);
    acc += x * gz;
    if (++k == K) {           // the next pixel (and sample)
      k = 0;
      if (++p == HW) {
        p = 0;
        ++b;
      }
      u = (float)(p % W);
      v = (float)(p / W);
    }
  }
}

// each thread takes 16-byte groups of logits (logits and dx 16-byte aligned)
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) softmax_decode_bwd_kernel(
    const T* __restrict__ logits, const float* __restrict__ temp_ptr, float temp_value,
    const float2* __restrict__ stats, const float2* __restrict__ coords,
    const float2* __restrict__ grad, T* __restrict__ dx, float* __restrict__ partials,
    unsigned* __restrict__ counter, float* __restrict__ dtemp, long long n, int HW, int W,
    int K) {
  __shared__ float red[kBwdThreads / 32];
  __shared__ bool last;
  const float temp = temp_ptr != nullptr ? *temp_ptr : temp_value;
  constexpr int N = Vec<T>::n;
  const long long groups = n / N;
  const long long stride = (long long)gridDim.x * kBwdThreads;
  float acc = 0.0f;
  for (long long gi = (long long)blockIdx.x * kBwdThreads + threadIdx.x; gi < groups;
       gi += stride) {
    alignas(16) T xv[N];
    alignas(16) T dv[N];
    *reinterpret_cast<uint4*>(xv) = __ldg(reinterpret_cast<const uint4*>(logits) + gi);
    bwd_group<T, N>(xv, dv, gi * N, HW, W, K, temp, stats, coords, grad, acc);
    reinterpret_cast<uint4*>(dx)[gi] = *reinterpret_cast<const uint4*>(dv);
  }
  // the elements past the last whole group
  if (blockIdx.x == 0 && threadIdx.x < n - groups * N) {
    const long long e = groups * N + threadIdx.x;
    T xv[1] = {logits[e]}, dv[1];
    bwd_group<T, 1>(xv, dv, e, HW, W, K, temp, stats, coords, grad, acc);
    dx[e] = dv[0];
  }
  if (dtemp == nullptr) return;

  // the block's sum in a fixed tree, then the partials in index order by the
  // last block to finish
  for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kBwdThreads / 32; ++w) s += red[w];
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kBwdThreads)
    s += __ldcg(partials + i);
  for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  __syncthreads();
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kBwdThreads / 32; ++w) t += red[w];
    *dtemp = t;
    *counter = 0u;
  }
}

template <typename T>
int launch_bwd(const void* logits, const float* temp, float temp_value, const void* stats,
               const void* coords, const void* grad, void* dx, float* partials,
               unsigned* counter, float* dtemp, long long n, int HW, int W, int K, int blocks,
               cudaStream_t stream) {
  softmax_decode_bwd_kernel<T><<<blocks, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(logits), temp, temp_value, static_cast<const float2*>(stats),
      static_cast<const float2*>(coords), static_cast<const float2*>(grad), static_cast<T*>(dx),
      partials, counter, dtemp, n, HW, W, K);
  return (int)cudaGetLastError();
}

}  // namespace

// logits (B, H, W, K) contiguous on the card, float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); temp: a float32 device pointer, or null to use
// temp_value; out (B, K, 2) float32; stats (B, K, 2) float32 (m, s) or null.
// The plan of softmax_decode.py::decode_plan: `splits` blocks per sample of
// ceil(H*W / splits) pixels each, read in pieces of `piece` pixels, `smem`
// bytes.
extern "C" int hrnet_fused_softmax_decode(const void* logits, const void* temp, float temp_value,
                                          void* out, void* stats, int B, int H, int W, int K,
                                          int is_bf16, int splits, int piece, int smem,
                                          void* stream) {
  const long long HW = (long long)H * W;
  const int es = is_bf16 ? 2 : 4;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || K < 1 || K > kMaxK ||
      HW > 2147483647LL / K / 4 || splits < 1 || splits > kMaxSplit || splits > HW ||
      piece < 1 || smem != state_bytes(K) + uv_bytes(piece) + piece * K * es + 16 ||
      smem > hrnet::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int range = (int)((HW + splits - 1) / splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(temp);
  float* st = static_cast<float*>(stats);
  return is_bf16 ? launch<__nv_bfloat16>(logits, tp, temp_value, out, st, B, (int)HW, W, K,
                                         splits, range, piece, smem, s)
                 : launch<float>(logits, tp, temp_value, out, st, B, (int)HW, W, K, splits,
                                 range, piece, smem, s);
}

// The backward of the above: logits, temp and temp_value as the forward took
// them; stats (B, K, 2) the forward's (m, s), coords its output, grad the
// upstream (B, K, 2) float32; dx (B, H, W, K) in the logits' type.  dtemp
// (one float32) gets dT when not null, summed through `partials` (`blocks`
// floats) and `counter` (one unsigned, 0 on entry and left 0).  logits and
// dx must be 16-byte aligned.  `blocks` is softmax_decode.py::
// decode_bwd_blocks.
extern "C" int hrnet_softmax_decode_bwd(const void* logits, const void* temp, float temp_value,
                                        const void* stats, const void* coords, const void* grad,
                                        void* dx, void* partials, void* counter, void* dtemp,
                                        int B, int H, int W, int K, int is_bf16, int blocks,
                                        void* stream) {
  const long long HW = (long long)H * W;
  const long long n = (long long)B * HW * K;
  if (B < 1 || H < 1 || W < 1 || K < 1 || K > kMaxK || HW > 2147483647LL / K || blocks < 1 ||
      blocks > kBwdMaxBlocks || (dtemp != nullptr && (partials == nullptr || counter == nullptr)) ||
      reinterpret_cast<uintptr_t>(logits) % 16 != 0 || reinterpret_cast<uintptr_t>(dx) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(temp);
  float* pp = static_cast<float*>(partials);
  unsigned* cp = static_cast<unsigned*>(counter);
  float* dt = static_cast<float*>(dtemp);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(logits, tp, temp_value, stats, coords, grad, dx, pp, cp, dt,
                                     n, (int)HW, W, K, blocks, s);
  return launch_bwd<float>(logits, tp, temp_value, stats, coords, grad, dx, pp, cp, dt, n,
                           (int)HW, W, K, blocks, s);
}
