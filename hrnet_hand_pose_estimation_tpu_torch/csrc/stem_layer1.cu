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
// the function computed is the TPU kernel's, in five launches.  y1 (the
// 128x128x64 stem1 output at 256x256, 2 MB a sample) lives only in shared
// memory, tile by tile, as in the TPU kernel; y2 goes through device memory.
//
// What bounds it on the H100: 0.4 GFLOP a sample against 0.9 MB of bf16 in
// and out, ~450 FLOP per byte, above the ~295 ridge: the tensor cores.  The
// first version reached neither bound: its weight fragments came from L2
// inside the WMMA loops and every accumulator went through a shared scratch.
//
// The design (on the shared mainloop of conv_mainloop.cuh): one block = one
// sample x a TH x TW tile of y2 (8 x 16 at 64 x 64) x all 64 channels.
// - The block's x_s2d window, (2TH+2) x (2TW+2) pixels, is staged once in
//   shared memory with its 12 channels padded to 16 (rows of 24 bf16, 48
//   bytes: an odd multiple of 16), 0 outside the image; ws1, padded the same
//   way to 4 taps x 16 K rows, beside it.
// - stem1 runs on the (2TH+1) x (2TW+1) y1 window that stem2 reads: each
//   lane's ldmatrix row address is its own y1 pixel's window row, a 2x2 tap
//   (16 K rows) an address offset.  Its epilogue writes y1 = bf16(relu(acc +
//   bs1)) from the registers to shared memory, 0 outside the image (stem2's
//   zero padding applies to y1).  y1's columns are stored even ones first,
//   then odd ones, so that stem2's stride-2 taps read consecutive rows.
// - stem2 reads y1 by ldmatrix with per-lane row addresses (pixel (2oy + kh,
//   2ox + kw) for tap (kh, kw)) and streams ws2, one 64-row slab per tap,
//   through a ring of cp.async stages that fills while stem1 runs; its
//   epilogue writes y2 from the registers.
// - 8 warps; products by mma.sync m16n8k16 (f32 sums).
// The launch plan (tile, ring depth, shared memory, grid) is made in Python,
// ops/kernels/fused_bottleneck.py::stem_plan; this entry checks it.
#include "conv_mainloop.cuh"

namespace hrnet {
namespace {

constexpr int kC = 64;                      // stem channels
constexpr int kCin = 12;                    // s2d input channels
constexpr int kLdX = 24;                    // bf16 per staged x_s2d pixel (16 used)
constexpr int kLdY = kC + 8;                // bf16 per y1 pixel and per weight row
constexpr int kTHMax = 8, kTWMax = 16;      // the largest y2 tile (4 x 2 m16 tiles of stem2)

struct StemArgs {
  const bf16* x;     // (B, Hs, Ws, 12) space-to-depth image
  bf16* y;           // (B, Hs/2, Ws/2, 64)
  const bf16* ws1;   // (4, 12, 64) = (48, 64), row tap*12 + c, tap = di*2 + dj
  const float* bs1;  // (64,)
  const bf16* ws2;   // (576, 64), row (kh*3 + kw)*64 + cin
  const float* bs2;  // (64,)
  int Hs, Ws;
  int TH, TW;        // y2 tile
  int stages;        // depth of the ws2 ring
};

// shared memory of a plan: x_s2d window, ws1, y1 window, ws2 ring
__host__ inline long stem_smem(int TH, int TW, int stages) {
  return 2L * ((2L * TH + 2) * (2 * TW + 2) * kLdX + 64L * kLdY +
               (2L * TH + 1) * (2 * TW + 1) * kLdY + (long)stages * kC * kLdY);
}

__global__ void __launch_bounds__(kThreads, 1) stem_s2d_kernel(StemArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int XW = 2 * a.TW + 2, x_px = (2 * a.TH + 2) * XW;   // x_s2d window
  const int YW = 2 * a.TW + 1, y1_px = (2 * a.TH + 1) * YW;  // y1 window
  const int half = a.TW + 1;                                 // even columns of a y1 row
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* w1s = xs + x_px * kLdX;
  bf16* y1 = w1s + 64 * kLdY;
  unsigned char* ring = reinterpret_cast<unsigned char*>(y1 + y1_px * kLdY);
  constexpr int stage_bytes = kC * kLdY * 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int Ho = a.Hs / 2, Wo = a.Ws / 2;
  const int tiles_x = (Wo + a.TW - 1) / a.TW;
  const int ox0 = (blockIdx.x % tiles_x) * a.TW, oy0 = (blockIdx.x / tiles_x) * a.TH;
  const int ya0 = 2 * oy0 - 1, yb0 = 2 * ox0 - 1;   // y1 window origin
  const int xa0 = ya0 - 1, xb0 = yb0 - 1;           // x_s2d window origin
  const size_t img = (size_t)blockIdx.y * a.Hs * a.Ws;

  // -- ws2 through the ring: slab j = tap j, 64 K rows x 64 channels
  auto load = [&](int j, unsigned char* st) {
    const bf16* src = a.ws2 + (size_t)j * kC * kC + (tid & 7) * 8;
    const unsigned dst = smem_u32(st) + (tid & 7) * 16;
    for (int r = tid >> 3; r < kC; r += kThreads / 8)
      cp_async16(dst + r * kLdY * 2, src + (size_t)r * kC, true);
  };
  ring_prologue(ring, stage_bytes, a.stages, 9, load);

  // -- the x_s2d window, four 8-byte parts a pixel (part 3: channels 12-15,
  // zero), 0 outside the image; ws1 as K rows tap * 16 + c, c >= 12 zero
  {
    const int part = tid & 3, pstep = kThreads / 4;
    int hy = (tid >> 2) / XW, hx = (tid >> 2) - hy * XW;
    for (int p = tid >> 2; p < x_px; p += pstep) {
      const int gy = xa0 + hy, gx = xb0 + hx;
      uint2 v = make_uint2(0, 0);
      if (part < 3 && gy >= 0 && gy < a.Hs && gx >= 0 && gx < a.Ws)
        v = __ldg(reinterpret_cast<const uint2*>(a.x + (img + (size_t)gy * a.Ws + gx) * kCin +
                                                 part * 4));
      *reinterpret_cast<uint2*>(xs + p * kLdX + part * 4) = v;
      for (hx += pstep; hx >= XW; hx -= XW) ++hy;
    }
    for (int i = tid; i < 64 * 8; i += kThreads) {   // 64 K rows x 8 vectors of 8 channels
      const int r = i >> 3, v = i & 7, tap = r >> 4, c = r & 15;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (c < kCin) w = __ldg(reinterpret_cast<const uint4*>(a.ws1 + (tap * kCin + c) * kC + v * 8));
      *reinterpret_cast<uint4*>(w1s + r * kLdY + v * 8) = w;
    }
  }
  __syncthreads();

  // -- stem1 on the y1 window, one m16 tile of window pixels at a time per
  // warp, all 64 channels (B fragments of the whole K = 64 held in registers)
  {
    constexpr int NT = 8;
    unsigned b[4][NT][2];
    const unsigned bl = smem_u32(w1s) + ((lane & 15) * kLdY + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int kq = 0; kq < 4; ++kq)
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        unsigned r[4];
        ldsm_x4_trans(r, bl + (kq * 16 * kLdY + jp * 16) * 2);
        b[kq][2 * jp][0] = r[0];
        b[kq][2 * jp][1] = r[1];
        b[kq][2 * jp + 1][0] = r[2];
        b[kq][2 * jp + 1][1] = r[3];
      }
    float bias[NT][2];
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const float2 bb = *reinterpret_cast<const float2*>(a.bs1 + jn * 8 + 2 * t4);
      bias[jn][0] = bb.x;
      bias[jn][1] = bb.y;
    }
    for (int m = warp * 16; m < y1_px; m += kWarps * 16) {
      int p = m + (lane & 15);
      if (p >= y1_px) p = 0;   // rows past the window: computed, never stored
      const int r = p / YW, c = p - r * YW;
      const unsigned al = smem_u32(xs + (r * XW + c) * kLdX + (lane >> 4) * 8);
      float acc[NT][4];
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jn][e] = 0.0f;
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {   // tap (di, dj) = (kq / 2, kq % 2)
        unsigned fa[4];
        ldsm_x4(fa, al + ((kq >> 1) * XW + (kq & 1)) * kLdX * 2);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) mma_bf16(acc[jn], fa, b[kq][jn]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = m + g + 8 * h;
        if (q >= y1_px) continue;
        const int qr = q / YW, qc = q - qr * YW;
        const int ya = ya0 + qr, yb = yb0 + qc;
        const bool in = ya >= 0 && ya < a.Hs && yb >= 0 && yb < a.Ws;
        bf16* dst = y1 + (qr * YW + (qc & 1) * half + (qc >> 1)) * kLdY + 2 * t4;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const float v0 = in ? fmaxf(acc[jn][2 * h] + bias[jn][0], 0.0f) : 0.0f;
          const float v1 = in ? fmaxf(acc[jn][2 * h + 1] + bias[jn][1], 0.0f) : 0.0f;
          *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }

  // -- stem2 (the first barrier of ring_run publishes y1): 4 warps along the
  // y2 pixels (2 m16 tiles each), 2 along the channels (32 each)
  {
    constexpr int MT = 2, NT = 4;
    const int wm = warp & 3, n0 = (warp >> 2) * 32, tile_px = a.TH * a.TW;
    unsigned al[MT];
    bool ok[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = (wm + 4 * i) * 16;
      ok[i] = m < tile_px;
      int p = m + (lane & 15);
      if (p >= tile_px) p = 0;
      const int py = p / a.TW, px = p - py * a.TW;
      al[i] = smem_u32(y1 + (2 * py * YW + px) * kLdY + (lane >> 4) * 8);   // y1 (2py, 2px)
    }
    const unsigned bl = ((lane & 15) * kLdY + n0 + (lane >> 4) * 8) * 2;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.0f;
    ring_run(ring, stage_bytes, a.stages, 9, 0, 9, load, [&](int j, unsigned char* st) {
      const int kh = j / 3, kw = j - kh * 3;   // column 2px + kw: even half or odd half
      const unsigned off = (kh * YW + (kw & 1) * half + (kw >> 1)) * kLdY * 2;
      const unsigned sb = smem_u32(st) + bl;
      for (int kq = 0; kq < kC; kq += 16) {
        unsigned b[NT][2], fa[MT][4];
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          unsigned r[4];
          ldsm_x4_trans(r, sb + (kq * kLdY + jp * 16) * 2);
          b[2 * jp][0] = r[0];
          b[2 * jp][1] = r[1];
          b[2 * jp + 1][0] = r[2];
          b[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (ok[i]) ldsm_x4(fa[i], al[i] + off + kq * 2);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (!ok[i]) continue;
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) mma_bf16(acc[i][jn], fa[i], b[jn]);
        }
      }
    });
    float bias[NT][2];
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const float2 bb = *reinterpret_cast<const float2*>(a.bs2 + n0 + jn * 8 + 2 * t4);
      bias[jn][0] = bb.x;
      bias[jn][1] = bb.y;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wm + 4 * i) * 16 + g + 8 * h;
        if (p >= tile_px) continue;
        const int py = p / a.TW, px = p - py * a.TW;
        const int gy = oy0 + py, gx = ox0 + px;
        if (gy >= Ho || gx >= Wo) continue;
        bf16* dst = a.y + (((size_t)blockIdx.y * Ho + gy) * Wo + gx) * kC + n0 + 2 * t4;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
          *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) = __floats2bfloat162_rn(
              fmaxf(acc[i][jn][2 * h] + bias[jn][0], 0.0f),
              fmaxf(acc[i][jn][2 * h + 1] + bias[jn][1], 0.0f));
      }
    }
  }
  cp_async_wait(0);
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// Launch the stem on PyTorch's stream with the plan of
// fused_bottleneck.py::stem_plan: x (B, Hs, Ws, 12) -> y (B, Hs/2, Ws/2, 64),
// Hs and Ws even, a y2 tile TH x TW, a ring of `stages` ws2 slabs, `smem`
// bytes, pointers 16-byte aligned (the wrapper checks).  A plan whose
// numbers do not add up returns cudaErrorInvalidValue; else
// cudaGetLastError() after the launch.
extern "C" int hrnet_stem_s2d(const void* x, void* y, const void* ws1, const void* bs1,
                              const void* ws2, const void* bs2, int B, int Hs, int Ws, int TH,
                              int TW, int stages, int smem, void* stream) {
  const bool ok = Hs % 2 == 0 && Ws % 2 == 0 && TH >= 1 && TW >= 1 && TH <= kTHMax &&
                  TW <= kTWMax && TH <= Hs / 2 && TW <= Ws / 2 && stages >= 2 && stages <= 8 &&
                  smem <= kSmemLimit && smem == stem_smem(TH, TW, stages);
  if (!ok) return (int)cudaErrorInvalidValue;
  StemArgs a{static_cast<const bf16*>(x),    static_cast<bf16*>(y),
             static_cast<const bf16*>(ws1),  static_cast<const float*>(bs1),
             static_cast<const bf16*>(ws2),  static_cast<const float*>(bs2),
             Hs, Ws, TH, TW, stages};
  static int raised[kMaxDevices] = {};
  const cudaError_t err = raise_smem(stem_s2d_kernel, smem, raised);
  if (err != cudaSuccess) return (int)err;
  const int Ho = Hs / 2, Wo = Ws / 2;
  const dim3 grid(((Wo + TW - 1) / TW) * ((Ho + TH - 1) / TH), B);
  stem_s2d_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
