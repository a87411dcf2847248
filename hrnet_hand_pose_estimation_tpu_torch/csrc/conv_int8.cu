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
// (upsampling fuse convs), at any Cin and Cout.
//
// Bit parity with JAX (each a trap of the port):
// - x / sa is a correctly rounded division, not a multiply by an f32 1/sa
//   (quantize() below: an f64 product that rounds to the same float);
// - rounding is half to even (rintf), the clip is to +-127;
// - sa * wscale is one f32 product made on the host before the kernel, and
//   the epilogue rounds the product and the sum separately (__fmul_rn,
//   __fadd_rn: nvcc would otherwise contract them into one FMA);
// - int32 sums are exact in any order; float(acc) rounds to nearest even as
//   XLA's convert.
//
// What bounds it on the H100: a w32 branch conv at 64x64 does 2*9*32*32 int8
// operations per output pixel against 128 bytes of bf16 in and out, ~144 per
// byte, below the card's ~590 int8 operations per byte: device memory bounds
// the small-channel sites, the int8 tensor cores the 256-channel ones.  The
// first version reached neither: each mma waited on 4-byte weight loads from
// L1/L2, and its 64-pixel tiles staged and re-quantized each input row three
// times.
//
// The design (an implicit GEMM on the shared mainloop of conv_mainloop.cuh):
// a block computes a TR x TW tile of output pixels of one image (about 512
// where NB = 32, 256 where NB = 64, else 128: eight, four or two rows at
// Wo = 64, the whole image at 8 x 8) for NB output channels.
// - It quantizes the tile's input halo once into shared memory (one x / sa
//   per input value per block, without __fdiv_rn's branch), pixel rows padded
//   to an odd multiple of 16 bytes so that ldmatrix is free of bank conflicts.
// - A comes from the halo by ldmatrix.x4 with per-lane row addresses (the
//   lane's own pixel, plus the tap's offset), so strided and 1x1 sites need
//   no im2col copy.
// - K walks (tap, KB-channel slice, KB = 64 where Cinp % 64 == 0, else 32);
//   the weights' (Cout, KH*KW*Cinp) rows are K-major, so each slab, NB rows x
//   KB bytes, streams through a ring of up to 4 stages by 16-byte cp.async
//   while earlier slabs are multiplied: no weight is read from global memory
//   inside the MMA loop.  The weights' channel pitch Cinp is Cin rounded up
//   to 16 (a view of zero-padded storage, ops/kernels/conv_int8.py::pad_kq,
//   made once with the site's weights), so every slab copy is 16-byte
//   aligned.  Where Cinp % 32 == 16 (the w48 widths 48, 96, 192, 384; the
//   narrow 8 and 40) the last slice of each tap holds 16 channels and the
//   ring zero-fills its upper 16 bytes, so the exact int32 sum is unchanged
//   (whatever A holds there) and nothing past channel Cinp is read.
// - Any width: the halo holds Cinp channels, those past Cin zero (staged by
//   16-byte vectors where Cin % 8 == 0, else element by element), and the
//   epilogue masks the channels past Cout.
// - 8 warps: WM along the pixels, 8 / WM along the channels, each an MT x NT
//   grid of m16n8k32 mma.sync tiles; the bit-exact epilogue runs from the
//   accumulator registers with scale and bias loaded once per thread.
// The launch plan (tile, warp grid, ring depth, shared memory, grid) is made
// in Python, ops/kernels/conv_int8.py::conv_int8_plan; this entry checks it.
// mma.sync and not wgmma: the MMAs do not bound this kernel (chip_ablation.py;
// PERF.md); wgmma is queued in ROADMAP.md.
#include "conv_mainloop.cuh"

namespace hrnet {
namespace {

struct ConvArgs {
  const bf16* x;          // (B, H, W, Cin)
  bf16* out;              // (B, Ho, Wo, Cout)
  const signed char* w;   // (Cout, KH, KW, Cinp): row n is K = KH*KW*Cinp contiguous
  const float* scale;     // (Cout,) sa * wscale
  const float* bias;      // (Cout,)
  const float* sa;        // () activation scale
  int B, H, W, Cin, Ho, Wo, Cout, KH, KW, stride, pad, relu;
  int TR, TW, HR, HC;     // tile rows/cols, halo rows/cols
  int ldh;                // halo bytes per pixel
  int KB;                 // input channels (bytes) of one tap per weight slab: 32 or 64
  int WM, NB, stages;     // warps along the pixels, channels per block, ring depth
  int Cinp;               // the weights' channel pitch: Cin rounded up to 16
};

// bytes per weight row of a ring stage: the slab's KB bytes + 16, an odd
// multiple of 16 (8 rows of an ldmatrix phase on 8 bank groups)
__host__ __device__ inline int ring_row(int KB) { return KB + 16; }

__host__ __device__ inline int halo_bytes(int HR, int HC, int ldh) {
  return (HR * HC * ldh + 127) / 128 * 128;
}

// the first n (< 8) of 8 bf16 values at p element by element, 0 past them:
// x's channel columns where Cin % 8 != 0
__device__ __forceinline__ uint4 load_tail8(const bf16* p, int n) {
  unsigned w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned lo = 2 * e < n ? __bfloat16_as_ushort(p[2 * e]) : 0u;
    const unsigned hi = 2 * e + 1 < n ? __bfloat16_as_ushort(p[2 * e + 1]) : 0u;
    w[e] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// clip(round(x / sa)) with x / sa rounded to f32 exactly as __fdiv_rn rounds
// it, computed as float(double(x) * rcp), rcp = 1.0 / double(sa) (both f64
// steps round to nearest).  Why that is exact: x is bf16, 8 significant bits,
// sa an f32, 24.  x / sa is never a midpoint between two floats (a midpoint
// has a 25-bit odd significand; x = mid * sa would put it in x's 8 bits), and
// a nonzero x - mid * sa is a multiple of 2^-49 |x| or coarser, so x / sa
// lies at a relative distance of at least 2^-49 from every midpoint, while
// the f64 product is within 2^-52 of x / sa: both round to the same float.
// No branch and no slow path: __fdiv_rn took one for zero dividends, half of
// a post-ReLU input (measured with chip_ablation.py's fdiv variant: 1.4-2x
// slower on the small sites).
__device__ __forceinline__ signed char quantize(float x, double rcp) {
  return clip_s8(__double2float_rn(__dmul_rn((double)x, rcp)));
}

// kAny: any Cin and Cout; else Cin % 16 == 0 and Cout % 8 == 0 (every w32 and
// w48 site), compiled apart so that those keep the code of the fixed-width
// kernel
template <int MT, int NT, bool kAny>
__global__ void __launch_bounds__(kThreads, (MT * NT <= 8) ? 4 : 2) conv_int8_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  signed char* halo = reinterpret_cast<signed char*>(smem);   // HR x HC x ldh int8
  unsigned char* ring = smem + halo_bytes(a.HR, a.HC, a.ldh);
  const int rowb = ring_row(a.KB), stage_bytes = a.NB * rowb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % a.WM, wn = warp / a.WM;
  const int tiles_x = (a.Wo + a.TW - 1) / a.TW, tiles_y = (a.Ho + a.TR - 1) / a.TR;
  const int tx = blockIdx.x % tiles_x, ty = (blockIdx.x / tiles_x) % tiles_y;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int oy0 = ty * a.TR, ox0 = tx * a.TW;
  const int iy0 = oy0 * a.stride - a.pad, ix0 = ox0 * a.stride - a.pad;
  const int nb0 = blockIdx.y * a.NB;   // the block's first output channel
  const int cinp = kAny ? a.Cinp : a.Cin;      // == Cin where Cin % 16 == 0
  const int K = a.KH * a.KW * cinp;
  const int cs = (cinp + a.KB - 1) / a.KB;   // slabs per tap (with KB 32 the last may hold 16)
  const int J = a.KH * a.KW * cs;

  // The copies give each thread one 16-byte column of a weight row or of a
  // halo pixel and step rows: no division per copy (a runtime division
  // per 16-byte copy took more instructions than the MMAs it fed).
  const int cpr = a.KB / 16, wstep = kThreads / cpr;   // 16-byte chunks per slab row
  const int part = tid % cpr, w0 = tid / cpr;

  // -- the weight stream: slab j = (tap, slice), NB rows x KB bytes
  auto load = [&](int j, unsigned char* st) {
    const int tap = j / cs, c0 = (j - tap * cs) * a.KB + part * 16;
    const unsigned dst = smem_u32(st) + part * 16;
    const signed char* src = a.w + (size_t)nb0 * K + tap * cinp + c0;
    for (int r = w0; r < a.NB; r += wstep) {
      const bool valid = nb0 + r < a.Cout && c0 < cinp;
      cp_async16(dst + r * rowb, valid ? src + (size_t)r * K : a.w, valid);
    }
  };
  ring_prologue(ring, stage_bytes, a.stages, J, load);

  // -- quantize the input halo once: clip(round(x / sa)), 0 outside the
  // image.  Each thread issues up to kBatch 16-byte loads before it
  // quantizes any, so that they are in flight together.
  constexpr int kBatch = 4;
  const double rcp = __drcp_rn((double)*a.sa);
  const int vpr = cinp / 8, pstep = kThreads / vpr, npx = a.HR * a.HC;
  const int v = tid % vpr, p0 = tid / vpr;   // p0 >= pstep: idle
  // this thread's 8 channels of x: all of them (16-byte loads, Cin % 8 == 0),
  // the first `tail` (element by element), or none (0 past Cin)
  const int tail = a.Cin - v * 8;
  const bool vec = a.Cin % 8 == 0 && tail > 0;
  const bf16* xb = a.x + (size_t)b * a.H * a.W * a.Cin + v * 8;
  int hy = p0 / a.HC, hx = p0 - hy * a.HC;
  for (int pix0 = p0; p0 < pstep && pix0 < npx; pix0 += kBatch * pstep) {
    uint4 raw[kBatch];
    if (!kAny || vec) {   // the loads of a batch stay in flight together
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int gy = iy0 + hy, gx = ix0 + hx;
        raw[u] = make_uint4(0, 0, 0, 0);
        if (pix0 + u * pstep < npx && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
          raw[u] = __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)gy * a.W + gx) * a.Cin));
        for (hx += pstep; hx >= a.HC; hx -= a.HC) ++hy;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int gy = iy0 + hy, gx = ix0 + hx;
        raw[u] = make_uint4(0, 0, 0, 0);
        if (tail > 0 && pix0 + u * pstep < npx && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
          raw[u] = load_tail8(xb + ((size_t)gy * a.W + gx) * a.Cin, tail < 8 ? tail : 8);
        for (hx += pstep; hx >= a.HC; hx -= a.HC) ++hy;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int pix = pix0 + u * pstep;
      if (pix >= npx) break;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      signed char q[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        q[2 * e] = quantize(f.x, rcp);
        q[2 * e + 1] = quantize(f.y, rcp);
      }
      *reinterpret_cast<uint2*>(halo + pix * a.ldh + v * 8) = pack8(q);
    }
  }
  // (the first barrier of ring_run publishes the halo)

  const int npix = a.TR * a.TW;
  const int n0 = wn * NT * 8;   // the warp's first channel inside the block
  // A rows: pixel p of m tile wm + i * WM at tap (0, 0); lanes 16-31 the upper 16 bytes
  unsigned a_lane[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int p = (wm + i * a.WM) * 16 + (lane & 15);
    if (p >= npix) p = 0;   // rows past the tile: computed, never stored
    const int oy = p / a.TW, ox = p - oy * a.TW;
    a_lane[i] = smem_u32(halo + (oy * a.stride * a.HC + ox * a.stride) * a.ldh + (lane >> 4) * 16);
  }
  // B rows (output channels) of a stage for ldmatrix: matrix q = lane / 8
  // holds channels n0 + (q / 2) * 8 .., bytes (q % 2) * 16 ..
  const unsigned b_lane = (n0 + ((lane >> 4) << 3) + (lane & 7)) * rowb + ((lane >> 3) & 1) * 16;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0;

  ring_run(ring, stage_bytes, a.stages, J, 0, J, load, [&](int j, unsigned char* st) {
    const int tap = j / cs, c0 = (j - tap * cs) * a.KB;
    const int ky = tap / a.KW, kx = tap - ky * a.KW;
    const unsigned tap_off = (ky * a.HC + kx) * a.ldh + c0;
    const unsigned sb = smem_u32(st) + b_lane;
    for (int kk = 0; kk < a.KB; kk += 32) {
      // every fragment load of the k32 step first, then the MMAs
      unsigned bf[NT][2], fa[MT][4];
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        unsigned r[4];
        ldsm_x4(r, sb + jp * 16 * rowb + kk);
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if ((wm + i * a.WM) * 16 < npix) ldsm_x4(fa[i], a_lane[i] + tap_off + kk);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if ((wm + i * a.WM) * 16 >= npix) continue;   // warp-uniform
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
          if (nb0 + n0 + jn * 8 < a.Cout) mma_s8(acc[i][jn], fa[i], bf[jn]);
      }
    }
  });
  cp_async_wait(0);

  // -- epilogue from the registers: bf16(relu?(float(acc) * scale + bias))
  float sc[NT][2], bi[NT][2];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    const int n = nb0 + n0 + jn * 8 + 2 * t4;
    const bool ok0 = n < a.Cout, ok1 = kAny ? n + 1 < a.Cout : ok0;
    sc[jn][0] = ok0 ? a.scale[n] : 0.0f;
    sc[jn][1] = ok1 ? a.scale[n + 1] : 0.0f;
    bi[jn][0] = ok0 ? a.bias[n] : 0.0f;
    bi[jn][1] = ok1 ? a.bias[n + 1] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (wm + i * a.WM) * 16 + g + 8 * h;
      if (p >= npix) continue;
      const int py = p / a.TW;
      const int oy = oy0 + py, ox = ox0 + p - py * a.TW;
      if (oy >= a.Ho || ox >= a.Wo) continue;
      bf16* dst = a.out + (((size_t)b * a.Ho + oy) * a.Wo + ox) * a.Cout + nb0 + n0 + 2 * t4;
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const int n = nb0 + n0 + jn * 8 + 2 * t4;
        if (kAny ? n >= a.Cout : nb0 + n0 + jn * 8 >= a.Cout) continue;
        float y0 = dequant(acc[i][jn][2 * h], sc[jn][0], bi[jn][0]);
        float y1 = dequant(acc[i][jn][2 * h + 1], sc[jn][1], bi[jn][1]);
        if (a.relu) {
          y0 = fmaxf(y0, 0.0f);
          y1 = fmaxf(y1, 0.0f);
        }
        if (!kAny || (n + 1 < a.Cout && a.Cout % 2 == 0)) {   // a 4-byte aligned pair
          *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) = __floats2bfloat162_rn(y0, y1);
        } else {
          dst[jn * 8] = __float2bfloat16(y0);
          if (n + 1 < a.Cout) dst[jn * 8 + 1] = __float2bfloat16(y1);
        }
      }
    }
  }
}

template <int MT, int NT, bool kAny>
int launch_as(const ConvArgs& a, int smem, cudaStream_t stream) {
  static int raised[kMaxDevices] = {};
  const cudaError_t err = raise_smem(conv_int8_kernel<MT, NT, kAny>, smem, raised);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((a.Wo + a.TW - 1) / a.TW) * ((a.Ho + a.TR - 1) / a.TR);
  const dim3 grid((unsigned)a.B * tiles, (a.Cout + a.NB - 1) / a.NB);
  conv_int8_kernel<MT, NT, kAny><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MT, int NT>
int launch(const ConvArgs& a, int smem, cudaStream_t stream) {
  return a.Cin % 16 == 0 && a.Cout % 8 == 0 ? launch_as<MT, NT, false>(a, smem, stream)
                                            : launch_as<MT, NT, true>(a, smem, stream);
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// One int8 site conv on PyTorch's stream with the plan of
// conv_int8.py::conv_int8_plan: tile TR x TW (halo HR x HC pixels of ldh
// bytes), KB channels per weight slab, WM warps along the pixels with MT m16 tiles each, NT n8 tiles per
// warp along NB = (8 / WM) * NT * 8 channels, a ring of `stages` slabs,
// `smem` bytes.  The weights' channel pitch Cinp is Cin rounded up to 16;
// x and w 16-byte aligned (the wrapper checks).  A plan this file has no instance for, or whose numbers
// do not add up, returns cudaErrorInvalidValue; else cudaGetLastError().
extern "C" int hrnet_conv_int8(const void* x, void* out, const void* w, const void* scale,
                               const void* bias, const void* sa, int B, int H, int W, int Cin,
                               int Cinp, int Ho, int Wo, int Cout, int KH, int KW, int stride, int pad,
                               int relu, int TR, int TW, int HR, int HC, int ldh, int KB, int WM,
                               int MT, int NT, int NB, int stages, int smem, void* stream) {
  const bool ok = Cinp % 16 == 0 && Cin >= 1 && Cin <= Cinp && Cinp - Cin < 16 &&
                  Cinp <= 8 * kThreads && Cout >= 1 && (WM == 2 || WM == 4 || WM == 8) &&
                  (kWarps / WM) * NT * 8 == NB && WM * MT * 16 >= TR * TW && TR >= 1 &&
                  TW >= 1 && HR == (TR - 1) * stride + KH && HC == (TW - 1) * stride + KW &&
                  ldh % 32 == 16 && ldh >= Cinp + 16 && (KB == 32 || (KB == 64 && Cinp % 64 == 0)) &&
                  stages >= 2 && stages <= 8 &&
                  smem == halo_bytes(HR, HC, ldh) + stages * NB * ring_row(KB) && smem <= kSmemLimit;
  if (!ok) return (int)cudaErrorInvalidValue;
  ConvArgs a{static_cast<const bf16*>(x),   static_cast<bf16*>(out),
             static_cast<const signed char*>(w), static_cast<const float*>(scale),
             static_cast<const float*>(bias),    static_cast<const float*>(sa),
             B, H, W, Cin, Ho, Wo, Cout, KH, KW, stride, pad, relu,
             TR, TW, HR, HC, ldh, KB, WM, NB, stages, Cinp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (MT == 1 && NT == 2) return launch<1, 2>(a, smem, s);
  if (MT == 1 && NT == 4) return launch<1, 4>(a, smem, s);
  if (MT == 2 && NT == 4) return launch<2, 4>(a, smem, s);
  if (MT == 2 && NT == 8) return launch<2, 8>(a, smem, s);
  if (MT == 4 && NT == 4) return launch<4, 4>(a, smem, s);
  return (int)cudaErrorInvalidValue;
}
