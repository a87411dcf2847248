// One BN-folded bottleneck block of HRNet's layer1, fused into one launch.
//
// Replaces the TPU kernel ops/pallas/fused_bottleneck.py::fused_bottleneck_chain
// (body _block_body): y = relu(conv1x1_3(relu(conv3x3_2(relu(conv1x1_1(x)))))
// + shortcut(x)), shortcut a folded 1x1 projection on block 0 and the identity
// on the others.  Activations bf16, accumulation f32, and the two
// intermediates rounded to bf16 where the TPU kernel rounds them.  The chain
// of four blocks is four launches of this kernel (ops/kernels/fused_bottleneck.py).
//
// What bounds it on the H100: layer1 does ~2.3 GFLOP per 64x64 sample against
// ~2.6 MB of activations in and out per sample, ~900 FLOP per byte, so it is
// above the card's ~295 FLOP/byte ridge: bf16 tensor-core throughput bounds
// it.  The design keeps a block's two intermediates in shared memory (they
// never touch device memory, as in the TPU kernel) and runs every product on
// the tensor cores through 16x16x16 WMMA tiles.  It pays for its simplicity
// with recomputation (the 1x1 conv of the 3x3's halo: 112 rows computed for
// 64 outputs), with the tensors between blocks going through device memory
// (one launch per block, where the TPU kernel kept the whole chain in VMEM),
// and with weight fragments read from L2 by every block; wgmma, TMA, weights
// resident in shared memory and one launch for the chain are later work.
//
// Tiling: one CUDA block = one sample x a 4-row x 16-column output tile.  The
// input halo (6 x 18 pixels, padded to 112 rows) is staged in shared memory;
// t1 = relu(x @ w1 + b1) is computed on the whole halo and set to 0 outside
// the image (the 3x3's zero padding applies to this intermediate, not to x);
// t2 = relu(conv3x3(t1) + b2) on the 64 output pixels; then t2 @ w3 + b3 plus
// the shortcut, ReLU, stored as bf16.  A 16-row A tile of the 3x3 is one
// output row, so its rows are contiguous in the halo layout.
#include "common.cuh"

namespace hrnet {
namespace {

constexpr int kTileW = 16, kTileH = 4;
constexpr int kHaloW = kTileW + 2, kHaloH = kTileH + 2;
constexpr int kHaloPix = kHaloW * kHaloH;   // 108
constexpr int kHaloRows = 112;               // 7 row tiles of 16
constexpr int kTilePix = kTileW * kTileH;    // 64

struct BlockArgs {
  const bf16* x;   // (B, H, W, Cin)
  bf16* out;       // (B, H, W, Cout)
  const bf16* w1;  // (Cin, Cm)
  const float* b1;
  const bf16* w2;  // (3, 3, Cm, Cm)
  const float* b2;
  const bf16* w3;  // (Cm, Cout)
  const float* b3;
  const bf16* ws;  // (Cin, Cout) projection shortcut, or null for identity
  const float* bs;
  int H, W, Cin, Cm, Cout;
};

__host__ __device__ inline size_t smem_bytes(int cin, int cm) {
  const int ldx = cin + kRowPad, ldt = cm + kRowPad;
  return (size_t)(kHaloRows * ldx + kHaloRows * ldt + kTilePix * ldt) * sizeof(bf16) +
         (size_t)kWarps * 256 * sizeof(float);
}

__global__ void __launch_bounds__(kThreads) bottleneck_kernel(BlockArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = a.Cin + kRowPad, ldt = a.Cm + kRowPad;
  bf16* xs = reinterpret_cast<bf16*>(smem);    // kHaloRows x ldx
  bf16* t1 = xs + kHaloRows * ldx;             // kHaloRows x ldt
  bf16* t2 = t1 + kHaloRows * ldt;             // kTilePix x ldt
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(t2 + kTilePix * ldt) + warp * 256;

  const int tiles_x = (a.W + kTileW - 1) / kTileW;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const size_t img = (size_t)blockIdx.y * a.H * a.W;

  // -- stage the input halo; pixels outside the image (and pad rows) are 0
  const int vec_per_row = a.Cin / 8;
  for (int i = threadIdx.x; i < kHaloRows * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row, v = i % vec_per_row;
    const int gy = y0 - 1 + r / kHaloW, gx = x0 - 1 + r % kHaloW;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < kHaloPix && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
      val = *reinterpret_cast<const uint4*>(a.x + (img + (size_t)gy * a.W + gx) * a.Cin + v * 8);
    *reinterpret_cast<uint4*>(xs + r * ldx + v * 8) = val;
  }
  __syncthreads();

  const int ntm = a.Cm / 16;
  FragA fa;
  FragB fb;
  FragC acc;

  // -- t1 = relu(x @ w1 + b1) on the halo, 0 outside the image
  for (int task = warp; task < (kHaloRows / 16) * ntm; task += kWarps) {
    const int mt = task / ntm, nt = task % ntm;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < a.Cin; k += 16) {
      wmma::load_matrix_sync(fa, xs + mt * 16 * ldx + k, ldx);
      wmma::load_matrix_sync(fb, a.w1 + (size_t)k * a.Cm + nt * 16, a.Cm);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = mt * 16 + e / 16, n = nt * 16 + e % 16;
      const int gy = y0 - 1 + row / kHaloW, gx = x0 - 1 + row % kHaloW;
      const bool inside = row < kHaloPix && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const float v = fmaxf(scratch[e] + a.b1[n], 0.0f);
      t1[row * ldt + n] = __float2bfloat16(inside ? v : 0.0f);
    }
    __syncwarp();
  }
  __syncthreads();

  // -- t2 = relu(conv3x3(t1) + b2); row tile oy = output row oy of the tile
  for (int task = warp; task < kTileH * ntm; task += kWarps) {
    const int oy = task / ntm, nt = task % ntm;
    wmma::fill_fragment(acc, 0.0f);
    for (int tap = 0; tap < 9; ++tap) {
      const bf16* arow = t1 + ((oy + tap / 3) * kHaloW + tap % 3) * ldt;
      const bf16* wtap = a.w2 + (size_t)tap * a.Cm * a.Cm + nt * 16;
      for (int k = 0; k < a.Cm; k += 16) {
        wmma::load_matrix_sync(fa, arow + k, ldt);
        wmma::load_matrix_sync(fb, wtap + (size_t)k * a.Cm, a.Cm);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int px = e / 16, n = nt * 16 + e % 16;
      t2[(oy * kTileW + px) * ldt + n] = __float2bfloat16(fmaxf(scratch[e] + a.b2[n], 0.0f));
    }
    __syncwarp();
  }
  __syncthreads();

  // -- out = relu(t2 @ w3 + b3 + shortcut(x))
  const int nto = a.Cout / 16;
  for (int task = warp; task < kTileH * nto; task += kWarps) {
    const int oy = task / nto, nt = task % nto;
    const bf16* xrow = xs + ((oy + 1) * kHaloW + 1) * ldx;   // the tile's input row
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < a.Cm; k += 16) {
      wmma::load_matrix_sync(fa, t2 + oy * kTileW * ldt + k, ldt);
      wmma::load_matrix_sync(fb, a.w3 + (size_t)k * a.Cout + nt * 16, a.Cout);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    if (a.ws != nullptr) {
      for (int k = 0; k < a.Cin; k += 16) {
        wmma::load_matrix_sync(fa, xrow + k, ldx);
        wmma::load_matrix_sync(fb, a.ws + (size_t)k * a.Cout + nt * 16, a.Cout);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    const int gy = y0 + oy;
    for (int e = lane; e < 256; e += 32) {
      const int px = e / 16, n = nt * 16 + e % 16;
      const int gx = x0 + px;
      float v = scratch[e] + a.b3[n];
      v += a.ws != nullptr ? a.bs[n] : __bfloat162float(xrow[px * ldx + n]);
      if (gy < a.H && gx < a.W)
        a.out[(img + (size_t)gy * a.W + gx) * a.Cout + n] = __float2bfloat16(fmaxf(v, 0.0f));
    }
    __syncwarp();
  }
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// Launch one folded bottleneck on PyTorch's stream.  Shapes must satisfy
// Cin, Cm, Cout % 16 == 0 and, without a projection, Cin == Cout (the
// wrapper checks).  Returns cudaGetLastError().
extern "C" int hrnet_bottleneck_block(const void* x, void* out, const void* w1, const void* b1,
                                      const void* w2, const void* b2, const void* w3,
                                      const void* b3, const void* ws, const void* bs, int B,
                                      int H, int W, int Cin, int Cm, int Cout, void* stream) {
  BlockArgs a{static_cast<const bf16*>(x),  static_cast<bf16*>(out),
              static_cast<const bf16*>(w1), static_cast<const float*>(b1),
              static_cast<const bf16*>(w2), static_cast<const float*>(b2),
              static_cast<const bf16*>(w3), static_cast<const float*>(b3),
              static_cast<const bf16*>(ws), static_cast<const float*>(bs),
              H, W, Cin, Cm, Cout};
  const size_t smem = smem_bytes(Cin, Cm);
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH), B);
  bottleneck_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* hrnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
