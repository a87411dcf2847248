// One W8A8 bottleneck block of HRNet's layer1, fused into one launch.
//
// Replaces the TPU kernel ops/pallas/int8_chain.py::fused_bottleneck_chain_int8
// (body _bottleneck_int8_body), with its parameters from prepare_layer1_int8:
//   xq  = clip(round(x * inv1))                         (x bf16 -> f32, inv1 = 1/sa1)
//   t1  = clip(round(relu(a1 * (xq @ kq1) + c1)))       int8, 1x1
//   t2  = clip(round(relu(a2 * conv3x3(t1, kq2) + c2))) int8, zero padding on t1
//   out = a3 * (t2 @ kq3) + c3                          f32
//   sc  = as * (xq @ kqs) + cs  (block 0: the projection reuses cb1's xq and sa1)
//       | float(x)              (identity)
//   y   = bf16(relu(out + sc))
// with int8 x int8 -> int32 products on the tensor cores (mma.sync.m16n8k32).
// The chain of four blocks is four launches (ops/kernels/int8_chain.py).
//
// Bit parity with JAX: the block input is MULTIPLIED by inv1 (the chain's
// own rule; the per-site walk divides), rounding is half to even (rintf),
// the clip is to +-127, every a*acc + c rounds the product and the sum
// separately (__fmul_rn, __fadd_rn: no FMA contraction), and the residual
// sum is taken in f32 on the bf16 input.
//
// What bounds it on the H100: at B=128 the chain does ~297 G int8
// operations (~0.15 ms at 1979 TOPS dense) and moves ~335 MB of bf16 in and
// out (~0.10 ms at 3.35 TB/s): the int8 tensor cores bound it.  The design
// keeps the structure of the bf16 chain (csrc/fused_bottleneck.cu): one CUDA
// block = one sample x a 4 x 16 output tile with a 6 x 18 halo; the block
// input is quantized once into shared memory, the 1x1 runs on the whole halo
// and its int8 output is set to 0 outside the image (the 3x3's zero padding
// applies to the requantized intermediate, not to x), and both int8
// intermediates stay in shared memory (half the bf16 chain's bytes).  Each
// block stages its weights transposed in shared memory (n rows, k contiguous)
// for the hand-loaded B fragments; that reload per tile, one launch per
// block and no TMA/wgmma are what this first version pays.
#include "common.cuh"

namespace hrnet {
namespace {

constexpr int kTileW = 16, kTileH = 4;
constexpr int kHaloW = kTileW + 2, kHaloH = kTileH + 2;
constexpr int kHaloPix = kHaloW * kHaloH;   // 108
constexpr int kHaloRows = 112;               // 7 row tiles of 16
constexpr int kTilePix = kTileW * kTileH;    // 64
constexpr int kPad8 = 16;                    // int8 row padding (bytes)

struct Int8BlockArgs {
  const bf16* x;            // (B, H, W, Cin)
  bf16* out;                // (B, H, W, Cout)
  const float* inv1;        // () 1/sa1
  const signed char* kq1;   // (Cin, Cm)
  const float *a1, *c1;     // (Cm,)
  const signed char* kq2;   // (9*Cm, Cm), rows (ky, kx, ci)
  const float *a2, *c2;     // (Cm,)
  const signed char* kq3;   // (Cm, Cout)
  const float *a3, *c3;     // (Cout,)
  const signed char* kqs;   // (Cin, Cout) projection shortcut, or null for identity
  const float *as, *cs;     // (Cout,)
  int H, W, Cin, Cm, Cout;
};

struct Layout {
  int ldx, ldt, ld2;
  size_t xq, t1, t2, w1, w2, w3, ws, total;
};

__host__ __device__ inline Layout layout(int cin, int cm, int cout, bool shortcut) {
  Layout l;
  l.ldx = cin + kPad8;
  l.ldt = cm + kPad8;
  l.ld2 = 9 * cm + kPad8;
  l.xq = 0;
  l.t1 = l.xq + (size_t)kHaloRows * l.ldx;
  l.t2 = l.t1 + (size_t)kHaloRows * l.ldt;
  l.w1 = l.t2 + (size_t)kTilePix * l.ldt;
  l.w2 = l.w1 + (size_t)cm * l.ldx;
  l.w3 = l.w2 + (size_t)cm * l.ld2;
  l.ws = l.w3 + (size_t)cout * l.ldt;
  l.total = l.ws + (shortcut ? (size_t)cout * l.ldx : 0);
  return l;
}

// dst[n * ld + k] = src[k * N + n]: a (K, N) weight as n rows with k contiguous
__device__ inline void stage_transposed(signed char* dst, int ld, const signed char* src, int K,
                                        int N) {
  for (int i = threadIdx.x; i < K * N; i += kThreads) dst[(i % N) * ld + i / N] = src[i];
}

__global__ void __launch_bounds__(kThreads) bottleneck_int8_kernel(Int8BlockArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool shortcut = a.kqs != nullptr;
  const Layout l = layout(a.Cin, a.Cm, a.Cout, shortcut);
  signed char* base = reinterpret_cast<signed char*>(smem);
  signed char *xq = base + l.xq, *t1 = base + l.t1, *t2 = base + l.t2;
  signed char *w1 = base + l.w1, *w2 = base + l.w2, *w3 = base + l.w3, *ws = base + l.ws;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const int tiles_x = (a.W + kTileW - 1) / kTileW;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const size_t img = (size_t)blockIdx.y * a.H * a.W;
  const float inv1 = *a.inv1;

  // -- quantize the input halo once: xq = clip(round(x * inv1)), 0 outside
  const int vec_per_row = a.Cin / 8;
  for (int i = threadIdx.x; i < kHaloRows * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row, v = i % vec_per_row;
    const int gy = y0 - 1 + r / kHaloW, gx = x0 - 1 + r % kHaloW;
    signed char q[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (r < kHaloPix && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          a.x + (img + (size_t)gy * a.W + gx) * a.Cin + v * 8);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        q[2 * j] = clip_s8(__fmul_rn(f.x, inv1));
        q[2 * j + 1] = clip_s8(__fmul_rn(f.y, inv1));
      }
    }
    *reinterpret_cast<uint2*>(xq + r * l.ldx + v * 8) = pack8(q);
  }
  stage_transposed(w1, l.ldx, a.kq1, a.Cin, a.Cm);
  stage_transposed(w2, l.ld2, a.kq2, 9 * a.Cm, a.Cm);
  stage_transposed(w3, l.ldt, a.kq3, a.Cm, a.Cout);
  if (shortcut) stage_transposed(ws, l.ldx, a.kqs, a.Cin, a.Cout);
  __syncthreads();

  unsigned fa[4], fb[2];
  int acc[4][4];

  // -- t1 = requant(xq @ kq1) on the halo; tasks: 7 row tiles x Cm/32 column groups
  const int ngm = a.Cm / 32;
  for (int task = warp; task < (kHaloRows / 16) * ngm; task += kWarps) {
    const int mt = task / ngm, n0 = (task % ngm) * 32;
    for (int j = 0; j < 4; ++j)
      for (int r = 0; r < 4; ++r) acc[j][r] = 0;
    for (int k = 0; k < a.Cin; k += 32) {
      load_a_s8(fa, xq + mt * 16 * l.ldx + k, l.ldx, lane);
      for (int j = 0; j < 4; ++j) {
        load_b_s8(fb, w1 + (n0 + j * 8) * l.ldx + k, l.ldx, lane);
        mma_s8(acc[j], fa, fb);
      }
    }
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + g + 8 * half;
      const int gy = y0 - 1 + row / kHaloW, gx = x0 - 1 + row % kHaloW;
      const bool inside = row < kHaloPix && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j * 8 + 2 * t;
        signed char* dst = t1 + row * l.ldt + n;
        dst[0] = inside ? requant_s8(acc[j][2 * half], a.a1[n], a.c1[n]) : 0;
        dst[1] = inside ? requant_s8(acc[j][2 * half + 1], a.a1[n + 1], a.c1[n + 1]) : 0;
      }
    }
  }
  __syncthreads();

  // -- t2 = requant(conv3x3(t1) @ kq2); row tile oy = output row oy of the tile
  for (int task = warp; task < kTileH * ngm; task += kWarps) {
    const int oy = task / ngm, n0 = (task % ngm) * 32;
    for (int j = 0; j < 4; ++j)
      for (int r = 0; r < 4; ++r) acc[j][r] = 0;
    for (int tap = 0; tap < 9; ++tap) {
      const signed char* arow = t1 + ((oy + tap / 3) * kHaloW + tap % 3) * l.ldt;
      for (int k = 0; k < a.Cm; k += 32) {
        load_a_s8(fa, arow + k, l.ldt, lane);
        for (int j = 0; j < 4; ++j) {
          load_b_s8(fb, w2 + (n0 + j * 8) * l.ld2 + tap * a.Cm + k, l.ld2, lane);
          mma_s8(acc[j], fa, fb);
        }
      }
    }
    for (int half = 0; half < 2; ++half) {
      const int px = g + 8 * half;
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j * 8 + 2 * t;
        signed char* dst = t2 + (oy * kTileW + px) * l.ldt + n;
        dst[0] = requant_s8(acc[j][2 * half], a.a2[n], a.c2[n]);
        dst[1] = requant_s8(acc[j][2 * half + 1], a.a2[n + 1], a.c2[n + 1]);
      }
    }
  }
  __syncthreads();

  // -- y = bf16(relu(dequant(t2 @ kq3) + shortcut)); tasks: 4 rows x Cout/32
  const int ngo = a.Cout / 32;
  int accs[4][4];
  for (int task = warp; task < kTileH * ngo; task += kWarps) {
    const int oy = task / ngo, n0 = (task % ngo) * 32;
    const signed char* xrow = xq + ((oy + 1) * kHaloW + 1) * l.ldx;   // the tile's input row
    for (int j = 0; j < 4; ++j)
      for (int r = 0; r < 4; ++r) acc[j][r] = accs[j][r] = 0;
    for (int k = 0; k < a.Cm; k += 32) {
      load_a_s8(fa, t2 + oy * kTileW * l.ldt + k, l.ldt, lane);
      for (int j = 0; j < 4; ++j) {
        load_b_s8(fb, w3 + (n0 + j * 8) * l.ldt + k, l.ldt, lane);
        mma_s8(acc[j], fa, fb);
      }
    }
    if (shortcut) {
      for (int k = 0; k < a.Cin; k += 32) {
        load_a_s8(fa, xrow + k, l.ldx, lane);
        for (int j = 0; j < 4; ++j) {
          load_b_s8(fb, ws + (n0 + j * 8) * l.ldx + k, l.ldx, lane);
          mma_s8(accs[j], fa, fb);
        }
      }
    }
    const int gy = y0 + oy;
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + g + 8 * half;
      if (gy >= a.H || gx >= a.W) continue;
      const size_t pix = img + (size_t)gy * a.W + gx;
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j * 8 + 2 * t;
        float v[2];
        for (int e = 0; e < 2; ++e) {
          const float out = dequant(acc[j][2 * half + e], a.a3[n + e], a.c3[n + e]);
          const float sc = shortcut ? dequant(accs[j][2 * half + e], a.as[n + e], a.cs[n + e])
                                    : __bfloat162float(a.x[pix * a.Cin + n + e]);
          v[e] = fmaxf(__fadd_rn(out, sc), 0.0f);
        }
        *reinterpret_cast<__nv_bfloat162*>(a.out + pix * a.Cout + n) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// Launch one W8A8 bottleneck on PyTorch's stream.  Cin, Cm, Cout % 32 == 0
// and, without a projection, Cin == Cout (the wrapper checks).  Returns
// cudaGetLastError().
extern "C" int hrnet_bottleneck_int8_block(const void* x, void* out, const void* inv1,
                                           const void* kq1, const void* a1, const void* c1,
                                           const void* kq2, const void* a2, const void* c2,
                                           const void* kq3, const void* a3, const void* c3,
                                           const void* kqs, const void* as, const void* cs,
                                           int B, int H, int W, int Cin, int Cm, int Cout,
                                           void* stream) {
  typedef const signed char* I8;
  typedef const float* F32;
  Int8BlockArgs a{static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<F32>(inv1),
                  static_cast<I8>(kq1), static_cast<F32>(a1), static_cast<F32>(c1),
                  static_cast<I8>(kq2), static_cast<F32>(a2), static_cast<F32>(c2),
                  static_cast<I8>(kq3), static_cast<F32>(a3), static_cast<F32>(c3),
                  static_cast<I8>(kqs), static_cast<F32>(as), static_cast<F32>(cs),
                  H, W, Cin, Cm, Cout};
  const size_t smem = layout(Cin, Cm, Cout, kqs != nullptr).total;
  cudaError_t err = cudaFuncSetAttribute(bottleneck_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH), B);
  bottleneck_int8_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
