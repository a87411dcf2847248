// The HRNet stem on the space-to-depth image: the first part of the port of
// the TPU kernel ops/pallas/fused_bottleneck.py::fused_stem_layer1 (body
// _stem_layer1_kernel).
//
//   y1 = bf16(relu(conv2x2(pad_top_left(x_s2d)) + bs1))     stem1, K = 4 taps x 12
//   y2 = bf16(relu(conv3x3_stride2(pad1(y1)) + bs2))         stem2, K = 9 taps x 64
//
// x_s2d is the 2x2 space-to-depth of the RGB image (B, H/2, W/2, 12), on which
// the 3x3/stride-2 stem1 is exactly a 2x2/stride-1 conv with one row and
// column of zero padding at the top and left (ops/s2d.py).  bf16 activations,
// f32 sums, y1 and y2 each rounded once, as the TPU kernel rounds.  The
// wrapper (ops/kernels/fused_bottleneck.py::fused_stem_layer1) then runs
// layer1 as four launches of the layer1 block kernel (csrc/fused_bottleneck.cu):
// the function computed is the TPU kernel's, in five launches.
//
// What stays on chip and what does not: y1 (the 128x128x64 stem1 output at
// 256x256, 2 MB a sample) lives only in shared memory, tile by tile, as in
// the TPU kernel; y2 (64x64x64, 0.5 MB a sample) and the tensors between the
// layer1 blocks go through device memory, where the TPU kernel kept the
// whole stem + layer1 of a sample in VMEM.
//
// What bounds it on the H100: 0.4 GFLOP a sample against 0.9 MB of bf16 in
// and out (~450 FLOP per byte), above the ~295 ridge: the tensor cores.
// The stem is ~5 % of the stem + layer1 work; both convs run on 16x16x16
// WMMA tiles with weight fragments from L1/L2 (9 KB and 72 KB).
//
// Tiling: one CUDA block = one sample x a 4-row x 16-column tile of y2.  It
// needs y1 on a 9 x 33 window (rows 2*oy0-1 .. 2*oy0+7), which it computes
// from an im2col copy of x_s2d (297 rows x 48 values, the four taps' 12
// channels side by side) and sets to 0 outside the image: stem2's zero
// padding applies to y1.  Output row oy of stem2, tap (kh, kw), reads y1
// window pixels (2*oy + kh, 2*ox + kw), ox = 0..15: one WMMA A tile whose
// rows are two pixels apart, i.e. a leading dimension of twice the pixel
// stride.
#include "common.cuh"

namespace hrnet {
namespace {

constexpr int kOutH = 4, kOutW = 16;                      // y2 tile
constexpr int kY1H = 2 * kOutH + 1, kY1W = 2 * kOutW + 1;  // y1 window 9 x 33
constexpr int kY1Pix = kY1H * kY1W;                        // 297
constexpr int kY1Rows = 304;                               // 19 row tiles of 16
constexpr int kCin = 12, kK1 = 4 * kCin;                   // stem1 K = 48
constexpr int kLdCols = kK1 + kRowPad;                     // 64
constexpr int kC = 64, kLdY = kC + kRowPad;                // 80

struct StemArgs {
  const bf16* x;     // (B, Hs, Ws, 12) space-to-depth image
  bf16* y;           // (B, Hs/2, Ws/2, 64)
  const bf16* ws1;   // (4, 12, 64) = (48, 64), row tap*12 + c, tap = di*2 + dj
  const float* bs1;  // (64,)
  const bf16* ws2;   // (576, 64), row (kh*3 + kw)*64 + cin
  const float* bs2;  // (64,)
  int Hs, Ws;
};

constexpr size_t kSmem = (size_t)kY1Rows * (kLdCols + kLdY) * sizeof(bf16) +
                         (size_t)kWarps * 256 * sizeof(float);

__global__ void __launch_bounds__(kThreads) stem_s2d_kernel(StemArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* cols = reinterpret_cast<bf16*>(smem);   // kY1Rows x kLdCols: stem1's im2col
  bf16* y1 = cols + kY1Rows * kLdCols;          // kY1Rows x kLdY
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(y1 + kY1Rows * kLdY) + warp * 256;

  const int Ho = a.Hs / 2, Wo = a.Ws / 2;
  const int tiles_x = (Wo + kOutW - 1) / kOutW;
  const int ox0 = (blockIdx.x % tiles_x) * kOutW, oy0 = (blockIdx.x / tiles_x) * kOutH;
  const int ya0 = 2 * oy0 - 1, yb0 = 2 * ox0 - 1;    // y1 window origin in y1 coordinates
  const size_t img = (size_t)blockIdx.y * a.Hs * a.Ws;

  // -- im2col of stem1: y1 pixel (ya, yb), tap (di, dj) reads x_s2d at
  //    (ya - 1 + di, yb - 1 + dj), 0 outside; 12 channels as three 8-byte words
  for (int i = threadIdx.x; i < kY1Rows * 12; i += kThreads) {
    const int p = i / 12, tap = (i % 12) / 3, part = i % 3;
    const int ya = ya0 + p / kY1W, yb = yb0 + p % kY1W;
    const int xa = ya - 1 + tap / 2, xb = yb - 1 + tap % 2;
    uint2 val = make_uint2(0, 0);
    if (p < kY1Pix && xa >= 0 && xa < a.Hs && xb >= 0 && xb < a.Ws)
      val = *reinterpret_cast<const uint2*>(a.x + (img + (size_t)xa * a.Ws + xb) * kCin + part * 4);
    *reinterpret_cast<uint2*>(cols + p * kLdCols + tap * kCin + part * 4) = val;
  }
  __syncthreads();

  FragA fa;
  FragB fb;
  FragC acc;

  // -- y1 = relu(cols @ ws1 + bs1) on the window, 0 outside the image
  for (int task = warp; task < (kY1Rows / 16) * (kC / 16); task += kWarps) {
    const int mt = task / (kC / 16), nt = task % (kC / 16);
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < kK1; k += 16) {
      wmma::load_matrix_sync(fa, cols + mt * 16 * kLdCols + k, kLdCols);
      wmma::load_matrix_sync(fb, a.ws1 + k * kC + nt * 16, kC);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int p = mt * 16 + e / 16, n = nt * 16 + e % 16;
      const int ya = ya0 + p / kY1W, yb = yb0 + p % kY1W;
      const bool inside = p < kY1Pix && ya >= 0 && ya < a.Hs && yb >= 0 && yb < a.Ws;
      const float v = fmaxf(scratch[e] + a.bs1[n], 0.0f);
      y1[p * kLdY + n] = __float2bfloat16(inside ? v : 0.0f);
    }
    __syncwarp();
  }
  __syncthreads();

  // -- y2 = relu(conv3x3/s2(y1) + bs2); row tile oy = output row oy of the tile
  for (int task = warp; task < kOutH * (kC / 16); task += kWarps) {
    const int oy = task / (kC / 16), nt = task % (kC / 16);
    wmma::fill_fragment(acc, 0.0f);
    for (int tap = 0; tap < 9; ++tap) {
      const bf16* arow = y1 + ((2 * oy + tap / 3) * kY1W + tap % 3) * kLdY;
      const bf16* wtap = a.ws2 + (size_t)tap * kC * kC + nt * 16;
      for (int k = 0; k < kC; k += 16) {
        wmma::load_matrix_sync(fa, arow + k, 2 * kLdY);
        wmma::load_matrix_sync(fb, wtap + (size_t)k * kC, kC);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    const int gy = oy0 + oy;
    for (int e = lane; e < 256; e += 32) {
      const int gx = ox0 + e / 16, n = nt * 16 + e % 16;
      if (gy < Ho && gx < Wo)
        a.y[(((size_t)blockIdx.y * Ho + gy) * Wo + gx) * kC + n] =
            __float2bfloat16(fmaxf(scratch[e] + a.bs2[n], 0.0f));
    }
    __syncwarp();
  }
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// Launch the stem on PyTorch's stream: x (B, Hs, Ws, 12) -> y (B, Hs/2,
// Ws/2, 64), Hs and Ws even (the wrapper checks).  Returns cudaGetLastError().
extern "C" int hrnet_stem_s2d(const void* x, void* y, const void* ws1, const void* bs1,
                              const void* ws2, const void* bs2, int B, int Hs, int Ws,
                              void* stream) {
  StemArgs a{static_cast<const bf16*>(x),    static_cast<bf16*>(y),
             static_cast<const bf16*>(ws1),  static_cast<const float*>(bs1),
             static_cast<const bf16*>(ws2),  static_cast<const float*>(bs2),
             Hs, Ws};
  cudaError_t err = cudaFuncSetAttribute(stem_s2d_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int Ho = Hs / 2, Wo = Ws / 2;
  const dim3 grid(((Wo + kOutW - 1) / kOutW) * ((Ho + kOutH - 1) / kOutH), B);
  stem_s2d_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
