// One BN-folded BasicBlock of an HRNet stage 2-4 branch, fused into one launch.
//
// Replaces the TPU kernel ops/pallas/fused_bottleneck.py::fused_basic_chain
// (body _basic_block_body_tb): per block
//   t = bf16(relu(conv3x3_1(x) + b1)),  y = bf16(relu((conv3x3_2(t) + b2) + x)),
// bf16 activations, f32 sums, t and y each rounded once, as the TPU kernel
// rounds.  A branch chain of n blocks is n launches of this kernel
// (ops/kernels/fused_bottleneck.py::fused_basic_chain).
//
// What bounds it on the H100: a 3x3 conv over C channels does 18*C^2
// operations per pixel against 4*C bytes of bf16 in and out, ~4.5*C per
// byte: above the card's ~295 bf16 FLOP per byte ridge from C = 64 on, so
// the tensor cores bound every branch but the 32-wide one, which is close.
// What held the first version back was latency, not either bound: its WMMA
// loop read every weight fragment from L1/L2 with nothing in flight ahead of
// use, one 8-warp block filled an SM, the flattened halo layout computed
// wrapped rows that were never used, and the epilogue went through an f32
// scratch in shared memory.
//
// The design (an implicit GEMM on the shared mainloop of conv_mainloop.cuh):
// one block = one sample x a TH x TW output tile x all C output channels
// (up to 16 x 32: the larger the tile, the fewer times the weights stream).
// - The input halo, (TH+4) x (TW+4) pixels, arrives once by cp.async (0
//   outside the image) into shared memory, rows padded to C + 8 bf16.
// - conv1 runs on exactly the (TH+2) x (TW+2) ring that conv2 reads: each
//   lane's ldmatrix row address is its own ring pixel's halo row plus the
//   tap's offset.  Its epilogue writes t = bf16(relu(acc + b1)) from the
//   accumulator registers to shared memory, 0 outside the image (conv2's
//   zero padding applies to t, not to x); t never touches device memory.
// - conv2 runs on the TH x TW tile pixels, reading t the same way, and its
//   epilogue adds b2 and the residual from the staged halo and writes y.
// - The weights, (9C, C) HWIO rows of each conv, stream through a ring of
//   3-4 slabs of KS rows (16 or 32 input channels of one tap) by 16-byte
//   cp.async: conv2's first slabs are in flight while conv1 finishes.  B
//   fragments come from the ring by ldmatrix.trans (the rows are N-major).
// - 8 warps: WM along the tile's pixels, 8 / WM along the channels, each an
//   MT x NT grid of m16n8k16 mma.sync tiles.  The launch plan (tile, warp
//   grid, ring depth, shared memory, grid) is made in Python,
//   ops/kernels/fused_bottleneck.py::basic_chain_plan; this entry checks it.
// mma.sync and not wgmma: the MMAs do not bound this kernel (chip_ablation.py;
// PERF.md); wgmma is queued in ROADMAP.md.
#include "conv_mainloop.cuh"

namespace hrnet {
namespace {

struct BasicArgs {
  const bf16* x;   // (B, H, W, C)
  bf16* out;       // (B, H, W, C)
  const bf16* w1;  // (3, 3, C, C) HWIO: K row tap * C + cin, C output channels
  const float* b1;
  const bf16* w2;
  const float* b2;
  int H, W, C;
  int TH, TW;      // output tile
  int WM;          // warps along the pixels; 8 / WM along the channels
  int KS;          // K rows (input channels of one tap) per weight slab
  int stages;      // depth of the weight ring
};

// shared memory of a plan: halo, t ring, weight ring (bf16 rows of C + 8)
__host__ inline long basic_smem(int C, int TH, int TW, int KS, int stages) {
  const long row = 2L * (C + 8);
  return row * ((TH + 4L) * (TW + 4) + (TH + 2L) * (TW + 2) + (long)stages * KS);
}

template <int MT, int NT>
__global__ void __launch_bounds__(kThreads, (MT * NT <= 8) ? 4 : (MT * NT <= 16) ? 2 : 1)
    basic_block_kernel(BasicArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, ld = C + 8;            // bf16 per shared-memory pixel row
  const int HW = a.TW + 4, RW = a.TW + 2;   // halo and t-ring widths
  const int halo_px = (a.TH + 4) * HW, ring_px = (a.TH + 2) * RW, tile_px = a.TH * a.TW;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ts = xs + halo_px * ld;
  unsigned char* ring = reinterpret_cast<unsigned char*>(ts + ring_px * ld);
  const int stage_bytes = a.KS * ld * 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % a.WM, wn = warp / a.WM;
  const int tiles_x = (a.W + a.TW - 1) / a.TW;
  const int x0 = (blockIdx.x % tiles_x) * a.TW, y0 = (blockIdx.x / tiles_x) * a.TH;
  const size_t img = (size_t)blockIdx.y * a.H * a.W;
  // The copies give each thread one 16-byte column v of a pixel or weight
  // row and step rows by rstep: no division per copy (a runtime division
  // per 16-byte copy took more instructions than the MMAs it fed).
  const int vpr = C / 8, rstep = kThreads / vpr;   // 16-byte vectors per row
  const int v = tid % vpr, r0 = tid / vpr;         // r0 >= rstep: idle copier

  // -- the input halo by cp.async, 0 outside the image (lands with slab 0)
  if (r0 < rstep) {
    int hy = r0 / HW, hx = r0 - hy * HW;
    for (int r = r0; r < halo_px; r += rstep) {
      const int gy = y0 - 2 + hy, gx = x0 - 2 + hx;
      const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const bf16* src = in ? a.x + (img + (size_t)gy * a.W + gx) * C + v * 8 : a.x;
      cp_async16(smem_u32(xs + r * ld + v * 8), src, in);
      for (hx += rstep; hx >= HW; hx -= HW) ++hy;
    }
  }

  // -- the weight stream: nk slabs of conv1, then nk of conv2
  const int nk = 9 * C / a.KS, J = 2 * nk;
  auto load = [&](int j, unsigned char* st) {
    if (r0 >= rstep) return;
    const bf16* src = (j < nk ? a.w1 : a.w2) + (size_t)(j % nk) * a.KS * C + v * 8;
    const unsigned dst = smem_u32(st) + v * 16;
    for (int r = r0; r < a.KS; r += rstep) cp_async16(dst + r * ld * 2, src + (size_t)r * C, true);
  };
  ring_prologue(ring, stage_bytes, a.stages, J, load);

  const int n0 = wn * NT * 8;   // the warp's first output channel
  // ldmatrix.trans rows of a stage: K row lane % 16, channels n0 + (lane / 16) * 8
  const unsigned b_lane = ((lane & 15) * ld + n0 + (lane >> 4) * 8) * 2;
  float bias[NT][2];
  float acc[MT][NT][4];

  for (int conv = 0; conv < 2; ++conv) {
    const int M = conv == 0 ? ring_px : tile_px;   // this conv's pixels
    const int DW = conv == 0 ? RW : a.TW;          // width of their grid
    const int SW = conv == 0 ? HW : RW;            // width of the grid they read
    const bf16* src = conv == 0 ? xs : ts;
    const float* bvec = conv == 0 ? a.b1 : a.b2;
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const float2 bb = *reinterpret_cast<const float2*>(bvec + n0 + jn * 8 + 2 * t4);
      bias[jn][0] = bb.x;
      bias[jn][1] = bb.y;
    }
    // each lane's A row: pixel p of m tile wm + i * WM, read at tap (0, 0)
    unsigned a_lane[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      int p = (wm + i * a.WM) * 16 + (lane & 15);
      if (p >= M) p = 0;   // rows past the conv's pixels: computed, never stored
      const int py = p / DW;
      a_lane[i] = smem_u32(src + (py * SW + p - py * DW) * ld + (lane >> 4) * 8);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.0f;

    ring_run(ring, stage_bytes, a.stages, J, conv * nk, conv * nk + nk, load,
             [&](int j, unsigned char* st) {
      const int k0 = (j - conv * nk) * a.KS;   // K row: tap * C + input channel
      const int tap = k0 / C, c0 = k0 - tap * C;
      const unsigned tap_off = (((tap / 3) * SW + tap % 3) * ld + c0) * 2;
      const unsigned sb = smem_u32(st) + b_lane;
      for (int kq = 0; kq < a.KS; kq += 16) {
        // every fragment load of the k step first, then the MMAs: the loads
        // are in flight together instead of each MMA row waiting on its own
        unsigned b[NT][2], fa[MT][4];
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          unsigned r[4];
          ldsm_x4_trans(r, sb + (kq * ld + jp * 16) * 2);
          b[2 * jp][0] = r[0];
          b[2 * jp][1] = r[1];
          b[2 * jp + 1][0] = r[2];
          b[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if ((wm + i * a.WM) * 16 < M) ldsm_x4(fa[i], a_lane[i] + tap_off + kq * 2);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if ((wm + i * a.WM) * 16 >= M) continue;   // warp-uniform
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) mma_bf16(acc[i][jn], fa[i], b[jn]);
        }
      }
    });

    // -- epilogues from the registers: c0, c1 at row g, c2, c3 at row g + 8,
    // columns 2 * t4 and 2 * t4 + 1 of each n8 tile
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wm + i * a.WM) * 16 + g + 8 * h;
        if (p >= M) continue;
        const int py = p / DW, px = p - py * DW;
        if (conv == 0) {
          // t = bf16(relu(conv1 + b1)) at ring pixel p, 0 outside the image
          const int gy = y0 - 1 + py, gx = x0 - 1 + px;
          const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
          bf16* dst = ts + p * ld + n0 + 2 * t4;
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            const float v0 = in ? fmaxf(acc[i][jn][2 * h] + bias[jn][0], 0.0f) : 0.0f;
            const float v1 = in ? fmaxf(acc[i][jn][2 * h + 1] + bias[jn][1], 0.0f) : 0.0f;
            *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) = __floats2bfloat162_rn(v0, v1);
          }
        } else {
          // y = bf16(relu((conv2 + b2) + x)) at tile pixel p
          const int gy = y0 + py, gx = x0 + px;
          if (gy >= a.H || gx >= a.W) continue;
          const bf16* res = xs + ((py + 2) * HW + px + 2) * ld + n0 + 2 * t4;
          bf16* dst = a.out + (img + (size_t)gy * a.W + gx) * C + n0 + 2 * t4;
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            const float2 r =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + jn * 8));
            const float v0 = (acc[i][jn][2 * h] + bias[jn][0]) + r.x;
            const float v1 = (acc[i][jn][2 * h + 1] + bias[jn][1]) + r.y;
            *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) =
                __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
          }
        }
      }
    }
  }
  cp_async_wait(0);   // no copy outlives the block (the tail groups are empty)
}

template <int MT, int NT>
int launch(const BasicArgs& a, int B, int smem, cudaStream_t stream) {
  static int raised[kMaxDevices] = {};
  const cudaError_t err = raise_smem(basic_block_kernel<MT, NT>, smem, raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.W + a.TW - 1) / a.TW) * ((a.H + a.TH - 1) / a.TH), B);
  basic_block_kernel<MT, NT><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// Launch one folded BasicBlock on PyTorch's stream with the plan of
// fused_bottleneck.py::basic_chain_plan: tile TH x TW, WM warps along the
// pixels with MT m16 tiles each, NT n8 tiles per warp along the channels
// ((8 / WM) * NT * 8 == C), KS channels per weight slab, a ring of `stages`
// slabs, `smem` bytes.  A plan this file has no instance for, or whose
// numbers do not add up, returns cudaErrorInvalidValue; else
// cudaGetLastError() after the launch.
extern "C" int hrnet_basic_block(const void* x, void* out, const void* w1, const void* b1,
                                 const void* w2, const void* b2, int B, int H, int W, int C,
                                 int TH, int TW, int WM, int MT, int NT, int KS, int stages,
                                 int smem, void* stream) {
  const bool ok = (WM == 1 || WM == 2 || WM == 4 || WM == 8) && (kWarps / WM) * NT * 8 == C &&
                  (KS == 16 || KS == 32) && C % KS == 0 && stages >= 2 && stages <= 8 &&
                  TH >= 1 && TW >= 1 && TH <= H && TW <= W && smem <= kSmemLimit &&
                  smem == basic_smem(C, TH, TW, KS, stages) &&
                  (WM * MT) * 16 >= (TH + 2) * (TW + 2);
  if (!ok) return (int)cudaErrorInvalidValue;
  BasicArgs a{static_cast<const bf16*>(x),  static_cast<bf16*>(out),
              static_cast<const bf16*>(w1), static_cast<const float*>(b1),
              static_cast<const bf16*>(w2), static_cast<const float*>(b2),
              H, W, C, TH, TW, WM, KS, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NT == 2 && MT == 8) return launch<8, 2>(a, B, smem, s);
  if (NT == 4 && MT == 2) return launch<2, 4>(a, B, smem, s);
  if (NT == 4 && MT == 4) return launch<4, 4>(a, B, smem, s);
  if (NT == 4 && MT == 6) return launch<6, 4>(a, B, smem, s);
  if (NT == 4 && MT == 8) return launch<8, 4>(a, B, smem, s);
  if (NT == 6 && MT == 2) return launch<2, 6>(a, B, smem, s);
  if (NT == 6 && MT == 4) return launch<4, 6>(a, B, smem, s);
  if (NT == 8 && MT == 4) return launch<4, 8>(a, B, smem, s);
  return (int)cudaErrorInvalidValue;
}
