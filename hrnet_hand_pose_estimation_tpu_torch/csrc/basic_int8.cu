// One W8A8 BasicBlock of an HRNet stage 2-4 branch, fused into one launch.
//
// Replaces the TPU kernel ops/pallas/int8_chain.py::fused_basic_chain_int8
// (body _basic_int8_body), with its parameters from prepare_branch_int8:
//   xq  = clip(round(x * inv1))                              x bf16 -> f32
//   t   = clip(round(relu(a1 * conv3x3(xq, kq1) + c1)))      int8, zero padding on xq
//   y   = bf16(relu((a2 * conv3x3(t, kq2) + c2) + float(x))) zero padding on t
// with int8 x int8 -> int32 products on the tensor cores (mma.sync.m16n8k32).
// A branch chain of n blocks is n launches (ops/kernels/int8_chain.py).
//
// Bit parity with JAX, as in csrc/int8_chain.cu: the block input is
// MULTIPLIED by inv1, rounding is half to even (rintf), the clip is to
// +-127, every a*acc + c rounds the product and the sum separately
// (__fmul_rn, __fadd_rn), and the residual is the bf16 block input in f32.
//
// What bounds it on the H100: a block's two 3x3 convs do 36*C^2 int8
// operations per pixel against 4*C bytes of bf16 in and out, 9*C per byte,
// against the card's ~590 int8 operations per byte: device memory bounds
// the 32-wide branch, the 64-wide one sits at the ridge, and the int8
// tensor cores bound the 128- and 256-wide ones.
//
// Design: the tile structure of the bf16 BasicBlock kernel
// (csrc/basic_chain.cu) with the int8 rules of the layer1 chain
// (csrc/int8_chain.cu).  One CUDA block = one sample x a TH x TW output
// tile (TW = min(W, 32), TH the largest of 8, 4, 2, 1 whose shared memory
// fits).  The input halo, (TH+4) x (TW+4) pixels, is quantized once into
// shared memory, row-major with row width HWd = TW + 4 and 0 outside the
// image; in that flattened layout a 3x3 tap is a constant row shift
// (dy*HWd + dx), so any 16 consecutive rows form an mma A tile for every
// tap, also on the 8- and 16-wide branches (rows on the halo's wrapped
// columns are computed and never used).  conv1 covers the (TH+2) x (TW+2)
// ring conv2 reads, and its int8 output t stays in shared memory, set to 0
// outside the image: conv2's zero padding applies to t, not to xq.
// mma.sync wants both operands with K contiguous, and the weights come as
// (9C, C) with the output channel contiguous, so each conv stages its
// weights transposed in shared memory, 32 output channels at a time (at
// C = 256 a whole 3x3 conv is 590 KB, more than shared memory holds), and
// every warp runs the full K loop (9 taps x 32-channel slices) for a
// 16-row tile and the slab's 32 channels.  Where C % 32 == 16 (the w48
// widths) the last K slice carries 16 channels with the upper half of its
// fragments set to 0, as in csrc/conv_int8.cu.  The weights reloaded per
// tile, one launch per block and no TMA/wgmma are what this first version
// pays.
#include "common.cuh"

namespace hrnet {
namespace {

constexpr int kSlab = 32;   // output channels per staged weight slab

struct BasicInt8Args {
  const bf16* x;           // (B, H, W, C)
  bf16* out;               // (B, H, W, C)
  const float* inv1;       // () 1/sa1
  const signed char* kq1;  // (9*C, C), rows (ky, kx, ci)
  const float *a1, *c1;    // (C,) folded with conv2's 1/sa2
  const signed char* kq2;  // (9*C, C)
  const float *a2, *c2;    // (C,) plain dequant
  int H, W, C;
  int TH, TW, HWd;         // tile rows and columns, halo row width TW + 4
  int M1, M2;              // rows computed by conv1 and by conv2 (multiples of 16)
  int XR;                  // rows of the staged input halo
  int ldx, ldw;            // bytes per row of the int8 activations and staged weights
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Bytes per shared-memory row of n int8 values (n % 16 == 0): n + 16 or
// n + 32, whichever makes the stride in 4-byte words 4 mod 8, so that the
// 8 rows one fragment load touches fall on 8 different groups of banks.
__host__ __device__ inline int row_stride(int n) {
  return ((n + 16) / 4) % 8 == 4 ? n + 16 : n + 32;
}

// The flattened layout, as in csrc/basic_chain.cu.  Halo row L = hr * HWd + hc
// holds image pixel (y0 - 2 + hr, x0 - 2 + hc).  conv1's row q is halo row
// q + HWd + 1 and conv2's row q is halo row q + 2*HWd + 2, so tap (dy, dx)
// of either reads its source at row q + dy*HWd + dx.  M1 >= M2 + 2*HWd + 2
// keeps every row conv2 reads inside conv1's rows, and XR >= M1 + 2*HWd + 2
// every row conv1 reads inside the staged halo.
__host__ inline BasicInt8Args geometry(int H, int W, int C, int TH) {
  BasicInt8Args a{};
  a.H = H;
  a.W = W;
  a.C = C;
  a.TH = TH;
  a.TW = W < 32 ? W : 32;
  a.HWd = a.TW + 4;
  a.M2 = round16((TH - 1) * a.HWd + a.TW);
  a.M1 = round16(a.M2 + 2 * a.HWd + 2);
  const int halo = (TH + 4) * a.HWd;
  a.XR = halo > a.M1 + 2 * a.HWd + 2 ? halo : a.M1 + 2 * a.HWd + 2;
  a.ldx = row_stride(C);
  a.ldw = row_stride(9 * C);
  return a;
}

__host__ inline size_t smem_bytes(const BasicInt8Args& a) {
  return (size_t)(a.XR + a.M1) * a.ldx + (size_t)kSlab * a.ldw;
}

// The int32 sums of a 3x3 conv over a flattened int8 source in shared memory
// (output row q, tap (dy, dx) reads source row q + dy*HWd + dx) for `rows`
// rows and all C output channels.  The weights kq (9C rows (ky, kx, ci) x C
// columns, device memory) are staged transposed into ws one slab of kSlab
// output channels at a time.  epi(q, n, acc_n, acc_n1) consumes the sums of
// row q at channels n and n + 1.  Starts with a barrier, so the source may
// have been written just before the call.
template <class Epi>
__device__ inline void conv3x3_int8(const signed char* src, int ld, int rows,
                                    const signed char* kq, int C, int HWd, signed char* ws,
                                    int ldw, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int K = 9 * C;
  for (int n0 = 0; n0 < C; n0 += kSlab) {
    const int nlen = C - n0 < kSlab ? C - n0 : kSlab;
    __syncthreads();   // the source is written and the previous slab is read
    // ws[n * ldw + k] = kq[k * C + n0 + n], four k per 32-bit store
    for (int i = threadIdx.x; i < (K / 4) * nlen; i += kThreads) {
      const int n = i % nlen, k = (i / nlen) * 4;
      const signed char* s = kq + (size_t)k * C + n0 + n;
      const unsigned w = (unsigned)(unsigned char)s[0] |
                         ((unsigned)(unsigned char)s[C] << 8) |
                         ((unsigned)(unsigned char)s[2 * C] << 16) |
                         ((unsigned)(unsigned char)s[3 * C] << 24);
      *reinterpret_cast<unsigned*>(ws + (size_t)n * ldw + k) = w;
    }
    __syncthreads();
    for (int mt = warp; mt < rows / 16; mt += kWarps) {
      int acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0;
      for (int tap = 0; tap < 9; ++tap) {
        const signed char* p0 =
            src + (size_t)(mt * 16 + (tap / 3) * HWd + tap % 3 + g) * ld + 4 * t;
        const signed char* p1 = p0 + 8 * ld;
        const signed char* wt = ws + (size_t)g * ldw + tap * C + 4 * t;
        for (int c0 = 0; c0 < C; c0 += 32) {
          // one 32-channel K slice; the last one of C % 32 == 16 carries 16
          const bool full = c0 + 32 <= C;
          unsigned fa[4], fb[2];
          fa[0] = *reinterpret_cast<const unsigned*>(p0 + c0);
          fa[1] = *reinterpret_cast<const unsigned*>(p1 + c0);
          fa[2] = full ? *reinterpret_cast<const unsigned*>(p0 + c0 + 16) : 0u;
          fa[3] = full ? *reinterpret_cast<const unsigned*>(p1 + c0 + 16) : 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j * 8 < nlen) {
              const signed char* pb = wt + (size_t)j * 8 * ldw + c0;
              fb[0] = *reinterpret_cast<const unsigned*>(pb);
              fb[1] = full ? *reinterpret_cast<const unsigned*>(pb + 16) : 0u;
              mma_s8(acc[j], fa, fb);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j * 8 < nlen) {
          const int n = n0 + j * 8 + 2 * t;
          epi(mt * 16 + g, n, acc[j][0], acc[j][1]);
          epi(mt * 16 + g + 8, n, acc[j][2], acc[j][3]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) basic_int8_kernel(BasicInt8Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  signed char* xq = reinterpret_cast<signed char*>(smem);   // XR x ldx: quantized halo
  signed char* ts = xq + (size_t)a.XR * a.ldx;              // M1 x ldx: t, conv1's rows
  signed char* ws = ts + (size_t)a.M1 * a.ldx;              // kSlab x ldw: staged weights

  const int tiles_x = (a.W + a.TW - 1) / a.TW;
  const int x0 = (blockIdx.x % tiles_x) * a.TW;
  const int y0 = (blockIdx.x / tiles_x) * a.TH;
  const size_t img = (size_t)blockIdx.y * a.H * a.W;
  const int HWd = a.HWd, C = a.C;
  const float inv1 = *a.inv1;

  // -- quantize the input halo once: clip(round(x * inv1)); 0 outside the
  //    image and on the slack rows
  const int vpr = C / 8, halo = (a.TH + 4) * HWd;
  for (int i = threadIdx.x; i < a.XR * vpr; i += kThreads) {
    const int r = i / vpr, v = i % vpr;
    const int gy = y0 - 2 + r / HWd, gx = x0 - 2 + r % HWd;
    signed char q[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (r < halo && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          a.x + (img + (size_t)gy * a.W + gx) * C + v * 8);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        q[2 * j] = clip_s8(__fmul_rn(f.x, inv1));
        q[2 * j + 1] = clip_s8(__fmul_rn(f.y, inv1));
      }
    }
    *reinterpret_cast<uint2*>(xq + (size_t)r * a.ldx + v * 8) = pack8(q);
  }

  // -- t = requant(conv1(xq)) on conv1's rows, 0 outside the image
  conv3x3_int8(xq, a.ldx, a.M1, a.kq1, C, HWd, ws, a.ldw, [&](int q, int n, int s0, int s1) {
    const int L = q + HWd + 1;
    const int gy = y0 - 2 + L / HWd, gx = x0 - 2 + L % HWd;
    const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    signed char* dst = ts + (size_t)q * a.ldx + n;
    dst[0] = inside ? requant_s8(s0, a.a1[n], a.c1[n]) : 0;
    dst[1] = inside ? requant_s8(s1, a.a1[n + 1], a.c1[n + 1]) : 0;
  });

  // -- y = bf16(relu(dequant(conv2(t)) + x)) on the tile's pixels
  conv3x3_int8(ts, a.ldx, a.M2, a.kq2, C, HWd, ws, a.ldw, [&](int q, int n, int s0, int s1) {
    const int L = q + 2 * HWd + 2;
    const int oy = L / HWd - 2, ox = L % HWd - 2;
    const int gy = y0 + oy, gx = x0 + ox;
    if (ox < 0 || ox >= a.TW || oy >= a.TH || gy >= a.H || gx >= a.W) return;
    const size_t off = (img + (size_t)gy * a.W + gx) * C + n;
    const float2 res = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.x + off));
    const float v0 = fmaxf(__fadd_rn(dequant(s0, a.a2[n], a.c2[n]), res.x), 0.0f);
    const float v1 = fmaxf(__fadd_rn(dequant(s1, a.a2[n + 1], a.c2[n + 1]), res.y), 0.0f);
    *reinterpret_cast<__nv_bfloat162*>(a.out + off) = __floats2bfloat162_rn(v0, v1);
  });
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// Launch one W8A8 BasicBlock on PyTorch's stream.  C % 16 == 0 (the wrapper
// checks); the tile height is the largest of 8, 4, 2, 1 rows (at most H)
// whose shared memory fits one block on an SM.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a C no tile fits.
extern "C" int hrnet_basic_int8_block(const void* x, void* out, const void* inv1,
                                      const void* kq1, const void* a1, const void* c1,
                                      const void* kq2, const void* a2, const void* c2, int B,
                                      int H, int W, int C, void* stream) {
  if (C <= 0 || C % 16) return (int)cudaErrorInvalidValue;
  const size_t limit = 227 * 1024;
  BasicInt8Args a{};
  bool found = false;
  for (int th = 8; th >= 1 && !found; th /= 2) {
    if (th > H && th > 1) continue;
    a = geometry(H, W, C, th);
    found = smem_bytes(a) <= limit;
  }
  if (!found) return (int)cudaErrorInvalidValue;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.inv1 = static_cast<const float*>(inv1);
  a.kq1 = static_cast<const signed char*>(kq1);
  a.a1 = static_cast<const float*>(a1);
  a.c1 = static_cast<const float*>(c1);
  a.kq2 = static_cast<const signed char*>(kq2);
  a.a2 = static_cast<const float*>(a2);
  a.c2 = static_cast<const float*>(c2);
  const size_t smem = smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(basic_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((W + a.TW - 1) / a.TW) * ((H + a.TH - 1) / a.TH), B);
  basic_int8_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
