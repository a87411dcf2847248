// W8A8 convolution of one int8 site of the HRNet trunk, as an implicit GEMM.
//
// Replaces the JAX package's core/quant_infer.py::_conv_int8, which XLA runs
// as an int8 x int8 -> int32 convolution (no Pallas kernel): the bf16 NHWC
// input is quantized by the site's calibrated scale sa,
//   xq = clip(round(x / sa), -127, 127),
// convolved with the per-output-channel int8 weights (zero padding (k-1)/2),
// and the int32 sums go through the f32 epilogue
//   y = bf16(relu?(float(acc) * (sa * wscale[c]) + bias[c])).
// One kernel serves every site of the 'exchange' scope: 3x3 stride 1 and 2
// (branch, transition and downsampling fuse convs, stem2) and 1x1 stride 1
// (upsampling fuse convs), Cin % 32 == 0, Cout % 8 == 0.
//
// Bit parity with JAX (each a trap of the port):
// - x / sa is a division (__fdiv_rn), not a multiply by 1/sa;
// - rounding is half to even (rintf), the clip is to +-127;
// - sa * wscale is one f32 product made on the host before the kernel, and
//   the epilogue rounds the product and the sum separately (__fmul_rn,
//   __fadd_rn: nvcc would otherwise contract them into one FMA);
// - int32 sums are exact; float(acc) rounds to nearest even as XLA's convert.
//
// What bounds it on the H100: a w32 branch conv at 64x64 does 2*9*32*32 int8
// operations per output pixel against 128 bytes of bf16 in and out, ~144 per
// byte, below the card's ~590 int8 operations per byte: device memory bounds
// the small-channel sites, the int8 tensor cores the 256-channel ones.
//
// Design: a CUDA block computes a tile of up to 64 output pixels of one
// image (TR rows x TW columns, TW = min(Wo, 64)) for 32 or 64 output
// channels.  It quantizes the tile's input halo once into shared memory
// (the taps then read int8 from there: each input value is divided once per
// block, not once per tap), and each of its 8 warps runs the whole K loop
// (taps x 32-channel slices) on mma.sync.m16n8k32 with its A fragments from
// the halo and its B fragments straight from the weights in global memory
// (L1/L2-resident: every block reads the same ones), with no barrier inside
// the loop.  No TMA, wgmma or fusion with the neighbouring ops (later work).
#include "common.cuh"

namespace hrnet {
namespace {

constexpr int kTilePix = 64;   // output pixels per block

struct ConvArgs {
  const bf16* x;             // (B, H, W, Cin)
  bf16* out;                 // (B, Ho, Wo, Cout)
  const signed char* w;      // (Cout, KH, KW, Cin): row n is K = KH*KW*Cin contiguous
  const float* scale;        // (Cout,) sa * wscale
  const float* bias;         // (Cout,)
  const float* sa;           // () activation scale
  int B, H, W, Cin, Ho, Wo, Cout, KH, KW, stride, pad, relu;
  int TR, TW, HR, HC;        // tile rows/cols, halo rows/cols
};

__host__ __device__ inline int halo_ld(int cin) { return cin + 16; }

// NJ: n8 tiles per warp; the block's 8 warps are 4 (16-pixel row tiles) x 2
// (NJ*8 channels), so a block covers NJ*16 output channels.
template <int NJ>
__global__ void __launch_bounds__(kThreads) conv_int8_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  signed char* halo = reinterpret_cast<signed char*>(smem);   // HR x HC x ldh int8
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ldh = halo_ld(a.Cin), K = a.KH * a.KW * a.Cin;
  const int tiles_x = (a.Wo + a.TW - 1) / a.TW, tiles_y = (a.Ho + a.TR - 1) / a.TR;
  const int tx = blockIdx.x % tiles_x, ty = (blockIdx.x / tiles_x) % tiles_y;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int oy0 = ty * a.TR, ox0 = tx * a.TW;
  const int iy0 = oy0 * a.stride - a.pad, ix0 = ox0 * a.stride - a.pad;
  const float sa = *a.sa;

  // -- quantize the input halo once: clip(round(x / sa)), 0 outside the image
  const int vpr = a.Cin / 8;
  for (int i = threadIdx.x; i < a.HR * a.HC * vpr; i += kThreads) {
    const int pix = i / vpr, v = i % vpr;
    const int gy = iy0 + pix / a.HC, gx = ix0 + pix % a.HC;
    signed char q[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          a.x + (((size_t)b * a.H + gy) * a.W + gx) * a.Cin + v * 8);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        q[2 * j] = clip_s8(__fdiv_rn(f.x, sa));
        q[2 * j + 1] = clip_s8(__fdiv_rn(f.y, sa));
      }
    }
    *reinterpret_cast<uint2*>(halo + pix * ldh + v * 8) = pack8(q);
  }
  __syncthreads();

  // -- this lane's two A rows (tile pixels p and p + 8) as halo offsets
  const int mt = warp & 3, nq = warp >> 2;
  const int npix = a.TR * a.TW;
  int off[2];
  for (int h = 0; h < 2; ++h) {
    int p = mt * 16 + g + 8 * h;
    if (p >= npix) p = 0;                      // padding rows: computed, never stored
    off[h] = ((p / a.TW) * a.stride * a.HC + (p % a.TW) * a.stride) * ldh + t * 4;
  }
  const int n_base = blockIdx.y * (NJ * 16) + nq * (NJ * 8);

  int acc[NJ][4];
  for (int j = 0; j < NJ; ++j)
    for (int r = 0; r < 4; ++r) acc[j][r] = 0;
  for (int ky = 0; ky < a.KH; ++ky) {
    for (int kx = 0; kx < a.KW; ++kx) {
      const int tap_off = (ky * a.HC + kx) * ldh;
      const int kbase = (ky * a.KW + kx) * a.Cin;
      for (int c0 = 0; c0 < a.Cin; c0 += 32) {
        unsigned fa[4], fb[2];
        const signed char* p0 = halo + off[0] + tap_off + c0;
        const signed char* p1 = halo + off[1] + tap_off + c0;
        fa[0] = *reinterpret_cast<const unsigned*>(p0);
        fa[1] = *reinterpret_cast<const unsigned*>(p1);
        fa[2] = *reinterpret_cast<const unsigned*>(p0 + 16);
        fa[3] = *reinterpret_cast<const unsigned*>(p1 + 16);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = n_base + j * 8;
          if (n >= a.Cout) continue;
          const signed char* wp = a.w + (size_t)(n + g) * K + kbase + c0 + t * 4;
          fb[0] = __ldg(reinterpret_cast<const unsigned*>(wp));
          fb[1] = __ldg(reinterpret_cast<const unsigned*>(wp + 16));
          mma_s8(acc[j], fa, fb);
        }
      }
    }
  }

  // -- epilogue: bf16(relu?(float(acc) * scale + bias))
  for (int j = 0; j < NJ; ++j) {
    const int n = n_base + j * 8 + 2 * t;
    if (n >= a.Cout) continue;
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + 8 * h;
      const int oy = oy0 + p / a.TW, ox = ox0 + p % a.TW;
      if (p >= npix || oy >= a.Ho || ox >= a.Wo) continue;
      float y0 = dequant(acc[j][2 * h], a.scale[n], a.bias[n]);
      float y1 = dequant(acc[j][2 * h + 1], a.scale[n + 1], a.bias[n + 1]);
      if (a.relu) {
        y0 = fmaxf(y0, 0.0f);
        y1 = fmaxf(y1, 0.0f);
      }
      *reinterpret_cast<__nv_bfloat162*>(
          a.out + (((size_t)b * a.Ho + oy) * a.Wo + ox) * a.Cout + n) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// One int8 site conv on PyTorch's stream.  Cin % 32 == 0, Cout % 8 == 0,
// pointers 16-byte aligned (the wrapper checks).  Returns cudaGetLastError().
extern "C" int hrnet_conv_int8(const void* x, void* out, const void* w, const void* scale,
                               const void* bias, const void* sa, int B, int H, int W, int Cin,
                               int Ho, int Wo, int Cout, int KH, int KW, int stride, int pad,
                               int relu, void* stream) {
  ConvArgs a{static_cast<const bf16*>(x),   static_cast<bf16*>(out),
             static_cast<const signed char*>(w), static_cast<const float*>(scale),
             static_cast<const float*>(bias),    static_cast<const float*>(sa),
             B, H, W, Cin, Ho, Wo, Cout, KH, KW, stride, pad, relu};
  a.TW = Wo < kTilePix ? Wo : kTilePix;
  a.TR = kTilePix / a.TW;
  a.HR = (a.TR - 1) * stride + KH;
  a.HC = (a.TW - 1) * stride + KW;
  const size_t smem = (size_t)a.HR * a.HC * halo_ld(Cin);
  const int nj = Cout <= 32 ? 2 : 4;
  void (*kernel)(ConvArgs) = nj == 2 ? conv_int8_kernel<2> : conv_int8_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((Wo + a.TW - 1) / a.TW) * ((Ho + a.TR - 1) / a.TR);
  const dim3 grid((unsigned)B * tiles, (Cout + nj * 16 - 1) / (nj * 16));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
