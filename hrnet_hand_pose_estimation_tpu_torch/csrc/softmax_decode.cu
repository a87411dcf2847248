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
// Bound: the bytes of the logits, read once (B*H*W*K*4 = 11 MB at B=32 for
// 64x64x21 float32, 3.3 us at 3.35 TB/s); the arithmetic (one expf and a few
// FMAs per element) is far below the card's float32 rate.  So the design
// reads every logit exactly once, coalesced, and keeps everything else on
// chip:
//
// - one block per sample; thread t = p * K + k of the block's P * K threads
//   owns joint k and the pixels p, p + P, p + 2P, ...  A pass of the block
//   over P consecutive pixels reads P * K consecutive logits, so every
//   load of a warp is contiguous (K is innermost in memory);
// - each thread keeps an online softmax of its pixels in registers: a
//   running max m and the sums s = sum e, su = sum e*u, sv = sum e*v taken
//   relative to m, rescaled by exp(m_old - m_new) when the max grows.  One
//   read of HBM, where a two-pass softmax would read the plane twice;
// - the P partial states of each joint are merged in shared memory by one
//   thread per joint, which divides once at the end, as the TPU kernel does.
//
// The arithmetic is IEEE: expf (not __expf) and a true division.  A plane of
// equal logits decodes to exactly ((W-1)/2, (H-1)/2); a plane with one logit
// far above the rest decodes to exactly that pixel (every other e_p and
// every rescale factor underflows to 0).  A NaN logit makes its joint NaN,
// as the plain softmax does.  The temperature is read through a device
// pointer (the model's trainable_temp) or passed by value, so the launch
// never waits for the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Online-softmax state of one thread, or of a merged group of threads.
struct State {
  float m, s, su, sv;
};

// Add one element x at pixel (u, v) to the state.
__device__ __forceinline__ void push(State& st, float x, float u, float v) {
  if (x > st.m) {
    // the new max: rescale what was summed relative to the old one (exactly
    // 0 on the first element, whose old max is -inf and sums are 0)
    const float r = expf(st.m - x);
    st.s = st.s * r + 1.0f;
    st.su = st.su * r + u;
    st.sv = st.sv * r + v;
    st.m = x;
  } else {
    // x == -inf contributes exactly 0, also while m is still -inf; a NaN x
    // fails both compares and makes the sums NaN
    const float e = (x == -INFINITY) ? 0.0f : expf(x - st.m);
    st.s += e;
    st.su += e * u;
    st.sv += e * v;
  }
}

template <typename T>
__global__ void softmax_decode_kernel(const T* __restrict__ logits, const float* __restrict__ temp_ptr,
                                      float temp_value, float* __restrict__ out, int HW, int W,
                                      int K, int P) {
  extern __shared__ float smem[];   // 4 * P * K floats: m, s, su, sv per thread
  const int b = blockIdx.x;
  const int t = threadIdx.x;        // t = p * K + k, t < P * K
  const int nt = P * K;
  const int p0 = t / K;
  const float temp = temp_ptr != nullptr ? *temp_ptr : temp_value;
  const T* x = logits + static_cast<size_t>(b) * HW * K;

  State st{-INFINITY, 0.0f, 0.0f, 0.0f};
  if (t < nt) {
    int pix = p0;
    int row = pix / W;
    int col = pix - row * W;
    const size_t stride = static_cast<size_t>(P) * K;
    size_t idx = static_cast<size_t>(t);
    const int drow = P / W;         // P = drow * W + dcol
    const int dcol = P - drow * W;
#pragma unroll 4
    for (; pix < HW; pix += P, idx += stride) {
      push(st, to_float(x[idx]) * temp, static_cast<float>(col), static_cast<float>(row));
      col += dcol;
      row += drow;
      if (col >= W) {
        col -= W;
        row += 1;
      }
    }
  }
  float* sm = smem;
  float* ss = smem + nt;
  float* su = smem + 2 * nt;
  float* sv = smem + 3 * nt;
  if (t < nt) {
    sm[t] = st.m;
    ss[t] = st.s;
    su[t] = st.su;
    sv[t] = st.sv;
  }
  __syncthreads();
  if (t < K) {
    float m = -INFINITY;
    for (int p = 0; p < P; ++p) m = fmaxf(m, sm[p * K + t]);
    float s = 0.0f, eu = 0.0f, ev = 0.0f;
    for (int p = 0; p < P; ++p) {
      const float mp = sm[p * K + t];
      // a thread that saw no finite element (m = -inf, sums 0) adds 0; an
      // all -inf plane gives NaN, as the plain softmax does
      const float r = (mp == -INFINITY && m != -INFINITY) ? 0.0f : expf(mp - m);
      s += ss[p * K + t] * r;
      eu += su[p * K + t] * r;
      ev += sv[p * K + t] * r;
    }
    float* o = out + (static_cast<size_t>(b) * K + t) * 2;
    o[0] = eu / s;
    o[1] = ev / s;
  }
}

// Threads per block: the largest P * K <= kTargetThreads (at least K).
constexpr int kTargetThreads = 512;
constexpr int kMaxK = 1024;

}  // namespace

// logits (B, H, W, K) contiguous on the card, float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); temp: a float32 device pointer, or null to use
// temp_value; out (B, K, 2) float32.
extern "C" int hrnet_fused_softmax_decode(const void* logits, const void* temp, float temp_value,
                                          void* out, int B, int H, int W, int K, int is_bf16,
                                          void* stream) {
  if (B < 1 || H < 1 || W < 1 || K < 1 || K > kMaxK ||
      static_cast<long long>(H) * W > 2147483647LL / K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int HW = H * W;
  const int P = K >= kTargetThreads ? 1 : kTargetThreads / K;
  const int threads = ((P * K + 31) / 32) * 32;
  const size_t smem = 4 * static_cast<size_t>(P) * K * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(temp);
  if (is_bf16) {
    softmax_decode_kernel<__nv_bfloat16><<<B, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(logits), tp, temp_value, static_cast<float*>(out), HW,
        W, K, P);
  } else {
    softmax_decode_kernel<float><<<B, threads, smem, s>>>(
        static_cast<const float*>(logits), tp, temp_value, static_cast<float*>(out), HW, W, K, P);
  }
  return static_cast<int>(cudaGetLastError());
}
