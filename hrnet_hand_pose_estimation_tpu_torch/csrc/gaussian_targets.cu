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
// Bound: the output bytes, B*H*W*K*4 (11 MB at B=32 for 64x64x21), read
// nothing of size; one exp per element is far below the card's f32 rate.  So
// the design only has to write every element once, coalesced: one block per
// (sample, output row) stages that sample's truncated centres and validity
// in shared memory, and its threads write consecutive floats of the row's
// W*K outputs.  Every element is written, zeros included (the output is not
// pre-zeroed).  expf is IEEE-accurate here (no fast-math), and the division
// by 2 sigma^2 is an IEEE division, as the TPU kernel divides.

#include <cuda_runtime.h>

namespace {

__global__ void gaussian_targets_kernel(const float* __restrict__ joints,
                                        const float* __restrict__ vis, float* __restrict__ out,
                                        int K, int res, int win, float sig2) {
  extern __shared__ int smem[];
  int* cx = smem;           // truncated centres of the valid joints
  int* cy = smem + K;
  int* ok = smem + 2 * K;   // validity
  const int y = blockIdx.x;
  const int b = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float tx = truncf(joints[(static_cast<size_t>(b) * K + k) * 2]);
    const float ty = truncf(joints[(static_cast<size_t>(b) * K + k) * 2 + 1]);
    const float fres = static_cast<float>(res);
    // float compares: NaN joints are invalid, and no out-of-range value is
    // ever converted to int
    const bool valid = vis[static_cast<size_t>(b) * K + k] > 0.0f && tx >= 0.0f &&
                       ty >= 0.0f && tx < fres && ty < fres;
    ok[k] = valid;
    cx[k] = valid ? static_cast<int>(tx) : 0;
    cy[k] = valid ? static_cast<int>(ty) : 0;
  }
  __syncthreads();
  const int row = res * K;
  float* o = out + (static_cast<size_t>(b) * res + y) * row;
  for (int i = threadIdx.x; i < row; i += blockDim.x) {
    const int x = i / K;
    const int k = i - x * K;
    const int dx = x - cx[k];
    const int dy = y - cy[k];
    float v = 0.0f;
    if (ok[k] && abs(dx) <= win && abs(dy) <= win)
      v = expf(-static_cast<float>(dx * dx + dy * dy) / sig2);
    o[i] = v;
  }
}

}  // namespace

// joints (B, K, 2) f32, vis (B, K) f32, out (B, res, res, K) f32, all
// contiguous on the card; win = int(3 sigma + 1), sig2 = 2 sigma^2.
extern "C" int hrnet_gaussian_targets(const void* joints, const void* vis, void* out, int B,
                                      int K, int res, int win, float sig2, void* stream) {
  if (B < 1 || K < 1 || res < 1 || B > 65535 || res > 65535 || K > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(res, B);
  const int threads = 256;
  const size_t smem = 3 * static_cast<size_t>(K) * sizeof(int);
  gaussian_targets_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(joints), static_cast<const float*>(vis),
      static_cast<float*>(out), K, res, win, sig2);
  return static_cast<int>(cudaGetLastError());
}
