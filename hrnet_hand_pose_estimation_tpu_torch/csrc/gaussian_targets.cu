// Gaussian heatmap targets for the 2D train step: (B, K, 2) joints + (B, K)
// visibility -> (B, H, W, K) float32, K innermost (NHWK, as the train step's
// heatmaps).
//
// Replaces the TPU kernel ops/pallas/decode_kernel.py::fused_gaussian_targets
// (its body _targets_kernel) of the JAX package:
//
//   out[b, y, x, k] = exp(-(dx^2 + dy^2) / (2 sigma^2))
//                     if |dx| <= win, |dy| <= win and joint (b, k) is valid,
//                     else exactly 0,
//
// with dx = x - trunc(u), dy = y - trunc(v) measured from the truncated centre,
// valid = vis > 0 and 0 <= trunc(u), trunc(v) < res, and win = int(3 sigma + 1)
// computed by the wrapper on the host.
//
// Bound: the output bytes, B*H*W*K*4 (11 MB at B=32, 44 MB at B=128 for
// 64x64x21); the joints are a few hundred bytes.  So the kernel is built to
// store at the card's rate:
// - a block writes a band of `rows` consecutive output rows of one sample,
//   one contiguous span of rows*W*K floats; the wrapper's plan
//   (ops/kernels/gaussian_targets.targets_plan) sizes the bands from B so the
//   grid keeps >= 512 blocks in flight;
// - the span goes out as 16-byte float4 stores, a scalar head up to the first
//   16-byte boundary and a scalar tail (W*K % 4 != 0, e.g. K = 17 or W = 63);
// - each thread walks (y, x, k) by increment and wrap, with no division per
//   element: one division locates its first chunk, then each step of
//   4 * blockDim elements adds precomputed carries;
// - the only values the output can take are exp(-n / 2 sigma^2) for n =
//   dx^2 + dy^2 in 0 .. 2 win^2 (99 at sigma 2): a table of them is filled in
//   shared memory once per block with the same float expression, so each
//   output is bit-identical to evaluating it, and the inner loop has no expf
//   (a sigma whose table does not fit evaluates expf per element instead);
// - a band that no valid joint's window reaches writes zeros only.
// Every element is written, zeros included (the output is not pre-zeroed).
// Default store policy: the loss reads the targets right after, from L2.
// expf is IEEE-accurate here (no fast-math), and the division by 2 sigma^2 is
// an IEEE division, as the TPU kernel divides.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFar = -(1 << 28);       // centre of an invalid joint: no window reaches it
constexpr int kSmemLimit = 48 * 1024;  // dynamic shared memory without an opt-in

struct Pos {
  int y, x, k;
};

struct Band {
  const int2* c;    // (cx, cy) per joint, in shared memory
  const float* lut; // exp(-n / sig2), n = 0 .. 2 win^2, in shared memory
  int K, res, win;
  float sig2;
  int y0;
};

// position of element e (counted from the band's first element)
__device__ __forceinline__ Pos locate(const Band& bd, long long e) {
  const long long row = static_cast<long long>(bd.res) * bd.K;
  const int r = static_cast<int>(e / row);
  const int i = static_cast<int>(e - r * row);
  const int x = i / bd.K;
  return Pos{bd.y0 + r, x, i - x * bd.K};
}

__device__ __forceinline__ void next(const Band& bd, Pos& p) {
  if (++p.k == bd.K) {
    p.k = 0;
    if (++p.x == bd.res) {
      p.x = 0;
      ++p.y;
    }
  }
}

// p += (sy, sx, sk) with sk < K and sx < res: one carry each at most
__device__ __forceinline__ void advance(const Band& bd, Pos& p, int sy, int sx, int sk) {
  p.k += sk;
  const int ck = p.k >= bd.K;
  p.k -= ck ? bd.K : 0;
  p.x += sx + ck;
  const int cx = p.x >= bd.res;
  p.x -= cx ? bd.res : 0;
  p.y += sy + cx;
}

template <bool kTable>
__device__ __forceinline__ float value(const Band& bd, const Pos& p) {
  const int2 j = bd.c[p.k];
  const int dx = p.x - j.x;
  const int dy = p.y - j.y;
  if (abs(dx) > bd.win || abs(dy) > bd.win) return 0.0f;
  const int n = dx * dx + dy * dy;
  return kTable ? bd.lut[n] : expf(-static_cast<float>(n) / bd.sig2);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <bool kTable>
__global__ void __launch_bounds__(kThreads)
    gaussian_targets_kernel(const float* __restrict__ joints, const float* __restrict__ vis,
                            float* __restrict__ out, int K, int res, int win, float sig2,
                            int rows) {
  extern __shared__ int smem[];
  int2* c = reinterpret_cast<int2*>(smem);
  float* lut = reinterpret_cast<float*>(smem + 2 * K);
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * rows;
  const int y1 = min(res, y0 + rows);
  int touched = 0;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float tx = truncf(joints[(static_cast<size_t>(b) * K + k) * 2]);
    const float ty = truncf(joints[(static_cast<size_t>(b) * K + k) * 2 + 1]);
    const float fres = static_cast<float>(res);
    // float compares: NaN joints are invalid, and no out-of-range value is
    // ever converted to int
    const bool valid = vis[static_cast<size_t>(b) * K + k] > 0.0f && tx >= 0.0f &&
                       ty >= 0.0f && tx < fres && ty < fres;
    const int cy = valid ? static_cast<int>(ty) : kFar;
    c[k] = make_int2(valid ? static_cast<int>(tx) : kFar, cy);
    touched |= valid && cy + win >= y0 && cy - win < y1;
  }
  if (kTable)
    for (int n = threadIdx.x; n <= 2 * win * win; n += kThreads)
      lut[n] = expf(-static_cast<float>(n) / sig2);
  touched = __syncthreads_or(touched);

  const Band bd{c, lut, K, res, win, sig2, y0};
  const long long row = static_cast<long long>(res) * K;
  const long long first = (static_cast<long long>(b) * res + y0) * row;
  const long long count = (y1 - y0) * row;
  float* o = out + first;
  // scalar head up to the first 16-byte boundary (out itself is 16-byte
  // aligned), float4 body, scalar tail
  const long long head = min(count, static_cast<long long>((4 - (first & 3)) & 3));
  const long long chunks = (count - head) >> 2;
  const long long tail0 = head + 4 * chunks;
  const int t = threadIdx.x;
  if (!touched) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (long long q = t; q < chunks; q += kThreads) store4(o + head + 4 * q, z);
    if (t < head) o[t] = 0.0f;
    if (tail0 + t < count) o[tail0 + t] = 0.0f;
    return;
  }
  if (t < head) o[t] = value<kTable>(bd, locate(bd, t));
  if (tail0 + t < count) o[tail0 + t] = value<kTable>(bd, locate(bd, tail0 + t));
  // the step of 4 * kThreads elements as carries of (y, x, k)
  const int step = 4 * kThreads;
  const int sk = step % K;
  const int sq = step / K;
  const int sx = sq % res;
  const int sy = sq / res;
  Pos p = locate(bd, head + 4LL * t);
  for (long long q = t; q < chunks; q += kThreads) {
    Pos s = p;
    float4 v;
    v.x = value<kTable>(bd, s);
    next(bd, s);
    v.y = value<kTable>(bd, s);
    next(bd, s);
    v.z = value<kTable>(bd, s);
    next(bd, s);
    v.w = value<kTable>(bd, s);
    store4(o + head + 4 * q, v);
    advance(bd, p, sy, sx, sk);
  }
}

}  // namespace

// joints (B, K, 2) f32, vis (B, K) f32, out (B, res, res, K) f32, all
// contiguous on the card, out 16-byte aligned; win = int(3 sigma + 1), sig2 =
// 2 sigma^2; the plan (targets_plan): rows per block, the exp table on or
// off, and the dynamic shared memory it needs.
extern "C" int hrnet_gaussian_targets(const void* joints, const void* vis, void* out, int B,
                                      int K, int res, int win, float sig2, int rows, int table,
                                      int smem, void* stream) {
  const long long lut = table ? (2LL * win * win + 1) * 4 : 0;
  if (B < 1 || K < 1 || res < 1 || win < 0 || B > 65535 || res > 65535 || K > 4096 ||
      rows < 1 || rows > res || (reinterpret_cast<size_t>(out) & 15) != 0 ||
      smem != 8LL * K + lut || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((res + rows - 1) / rows, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* j = static_cast<const float*>(joints);
  const float* v = static_cast<const float*>(vis);
  float* o = static_cast<float*>(out);
  if (table)
    gaussian_targets_kernel<true><<<grid, kThreads, smem, s>>>(j, v, o, K, res, win, sig2, rows);
  else
    gaussian_targets_kernel<false><<<grid, kThreads, smem, s>>>(j, v, o, K, res, win, sig2, rows);
  return static_cast<int>(cudaGetLastError());
}
