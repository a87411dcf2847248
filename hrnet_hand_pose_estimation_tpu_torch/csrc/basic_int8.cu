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
// Bit parity with JAX, as in int8_chain.cu: the block input is MULTIPLIED
// by inv1, rounding is half to even (rintf), the clip is to +-127, every
// a*acc + c rounds the product and the sum separately (__fmul_rn,
// __fadd_rn), and the residual is the bf16 block input in f32.
//
// What bounds it on the H100: a block's two 3x3 convs do 36*C^2 int8
// operations per pixel against 4*C bytes of bf16 in and out, 9*C per byte,
// against the card's ~590 int8 operations per byte: device memory bounds
// the 32-wide branch, the 64-wide one sits at the ridge, and the int8
// tensor cores bound the 128- and 256-wide ones.
//
// The design (an implicit GEMM on the shared mainloop of conv_mainloop.cuh,
// the structure of the bf16 BasicBlock kernel basic_chain.cu with the int8
// operands of conv_int8.cu): one block = one sample x a TH x TW output tile
// (up to 16 x 32) x all C output channels.
// - The input halo, (TH+4) x (TW+4) pixels, is quantized once into shared
//   memory, int8 rows at an odd multiple of 16 bytes, 0 outside the image.
// - conv1 runs on exactly the (TH+2) x (TW+2) ring that conv2 reads: each
//   lane's ldmatrix row address is its own ring pixel's halo row plus the
//   tap's offset.  Its requant epilogue writes t from the accumulator
//   registers to shared memory, 0 outside the image (conv2's zero padding
//   applies to t, not to xq); t never touches device memory.
// - conv2 runs on the TH x TW tile pixels, reading t the same way; its
//   epilogue dequantizes, adds the residual (read from device memory, where
//   this block's own halo load has just left it in L2) and writes y.
// - The weights arrive N-major (prepare_branch_int8 stores each kq as the
//   (9C, C) view of (C, 9C) storage), so B comes from the ring by ldmatrix
//   without .trans.  Slabs of KB = 64 (else 32) input channels of one tap x
//   all C output channels stream through a ring of 2-4 stages by 16-byte
//   cp.async: conv2's first slabs are in flight while conv1 finishes.
//   Where C % 32 == 16 (the w48 widths) the last slab of each tap holds 16
//   channels and the ring zero-fills its upper 16 bytes, so the int32 sum is
//   exact whatever A holds there.
// - 8 warps: WM along the tile's pixels, 8 / WM along the channels, each an
//   MT x NT grid of m16n8k32 mma.sync tiles.  The launch plan (tile, warp
//   grid, slab width, ring depth, shared memory, grid) is made in Python,
//   ops/kernels/int8_chain.py::basic_int8_plan; this entry checks it.
#include "conv_mainloop.cuh"

namespace hrnet {
namespace {

struct BasicInt8Args {
  const bf16* x;           // (B, H, W, C)
  bf16* out;               // (B, H, W, C)
  const float* inv1;       // () 1/sa1
  const signed char* w1;   // kq1 N-major: (C, 9C), K = tap * C + ci
  const float *a1, *c1;    // (C,) folded with conv2's 1/sa2
  const signed char* w2;   // kq2 N-major: (C, 9C)
  const float *a2, *c2;    // (C,) plain dequant
  int H, W, C;
  int TH, TW;              // output tile
  int WM;                  // warps along the pixels; 8 / WM along the channels
  int KB;                  // bytes (input channels of one tap) per weight slab: 32 or 64
  int stages;              // depth of the weight ring
};

// shared memory of a plan: quantized halo, t ring, weight ring
__host__ inline long basic_int8_smem(int C, int TH, int TW, int KB, int stages) {
  return (long)pitch_s8(C) * ((TH + 4L) * (TW + 4) + (TH + 2L) * (TW + 2)) +
         (long)stages * C * (KB + 16);
}

template <int MT, int NT>
__global__ void __launch_bounds__(kThreads, (MT * NT <= 8) ? 4 : (MT * NT <= 16) ? 2 : 1)
    basic_int8_kernel(BasicInt8Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, ld = pitch_s8(C);      // bytes per shared-memory pixel row
  const int HW = a.TW + 4, RW = a.TW + 2;   // halo and t-ring widths
  const int halo_px = (a.TH + 4) * HW, ring_px = (a.TH + 2) * RW, tile_px = a.TH * a.TW;
  signed char* xs = reinterpret_cast<signed char*>(smem);
  signed char* ts = xs + halo_px * ld;
  unsigned char* ring = reinterpret_cast<unsigned char*>(ts + ring_px * ld);
  const int rowb = a.KB + 16, stage_bytes = C * rowb;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % a.WM, wn = warp / a.WM;
  const int tiles_x = (a.W + a.TW - 1) / a.TW;
  const int x0 = (blockIdx.x % tiles_x) * a.TW, y0 = (blockIdx.x / tiles_x) * a.TH;
  const size_t img = (size_t)blockIdx.y * a.H * a.W;

  // -- the weight stream: slab j = (conv, tap, slice of KB channels), C rows
  // of KB bytes; each thread copies one 16-byte column and steps rows.  A
  // column past C (the upper half of a 16-channel tail) is zero-filled.
  const int cs = (C + a.KB - 1) / a.KB;   // slabs per tap
  const int nk = 9 * cs, J = 2 * nk, K = 9 * C;
  const int cpr = a.KB / 16, rstep = kThreads / cpr;
  const int part = tid % cpr, r0 = tid / cpr;
  auto load = [&](int j, unsigned char* st) {
    const int conv = j / nk, jj = j - conv * nk, tap = jj / cs;
    const int c = (jj - tap * cs) * a.KB + part * 16;
    const bool valid = c < C;
    const signed char* src = (conv ? a.w2 : a.w1) + tap * C + c;
    const unsigned dst = smem_u32(st) + part * 16;
    for (int r = r0; r < C; r += rstep)
      cp_async16(dst + r * rowb, valid ? src + (size_t)r * K : a.w1, valid);
  };
  ring_prologue(ring, stage_bytes, a.stages, J, load);

  // -- the input halo, quantized once while the first slabs are in flight
  // (the first barrier of conv1's ring_run publishes it)
  quantize_window(xs, ld, a.x + img * C, a.H, a.W, C, y0 - 2, x0 - 2, HW, halo_px, *a.inv1);

  const int n0 = wn * NT * 8;   // the warp's first output channel
  const unsigned bl = b_lane_s8(n0, rowb, lane);
  int acc[MT][NT][4];

  for (int conv = 0; conv < 2; ++conv) {
    const int M = conv == 0 ? ring_px : tile_px;   // this conv's pixels
    const int DW = conv == 0 ? RW : a.TW;          // width of their grid
    const int SW = conv == 0 ? HW : RW;            // width of the grid they read
    const signed char* src = conv == 0 ? xs : ts;
    // each lane's A row: pixel p of m tile wm + i * WM, read at tap (0, 0)
    unsigned al[MT];
    bool ok[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = (wm + i * a.WM) * 16;
      ok[i] = m < M;
      int p = m + (lane & 15);
      if (p >= M) p = 0;   // rows past the conv's pixels: computed, never stored
      const int py = p / DW;
      al[i] = a_lane_s8(src, py * SW + p - py * DW, ld, lane);
    }
    zero_s32(acc);
    ring_run(ring, stage_bytes, a.stages, J, conv * nk, conv * nk + nk, load,
             [&](int j, unsigned char* st) {
      const int jj = j - conv * nk, tap = jj / cs;
      const unsigned off = ((tap / 3) * SW + tap % 3) * ld + (jj - tap * cs) * a.KB;
      slab_mma_s8<MT, NT>(acc, al, ok, off, smem_u32(st) + bl, rowb, a.KB);
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
          // t = requant(conv1) at ring pixel p, 0 outside the image
          const int gy = y0 - 1 + py, gx = x0 - 1 + px;
          const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            const int n = n0 + jn * 8 + 2 * t4;
            const float2 s = *reinterpret_cast<const float2*>(a.a1 + n);
            const float2 c = *reinterpret_cast<const float2*>(a.c1 + n);
            store_s8x2(ts + p * ld + n, in ? requant_s8(acc[i][jn][2 * h], s.x, c.x) : 0,
                       in ? requant_s8(acc[i][jn][2 * h + 1], s.y, c.y) : 0);
          }
        } else {
          // y = bf16(relu((a2 * conv2 + c2) + float(x))) at tile pixel p
          const int gy = y0 + py, gx = x0 + px;
          if (gy >= a.H || gx >= a.W) continue;
          const size_t off = (img + (size_t)gy * a.W + gx) * C;
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            const int n = n0 + jn * 8 + 2 * t4;
            const float2 s = *reinterpret_cast<const float2*>(a.a2 + n);
            const float2 c = *reinterpret_cast<const float2*>(a.c2 + n);
            const float2 r =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.x + off + n));
            const float v0 = __fadd_rn(dequant(acc[i][jn][2 * h], s.x, c.x), r.x);
            const float v1 = __fadd_rn(dequant(acc[i][jn][2 * h + 1], s.y, c.y), r.y);
            *reinterpret_cast<__nv_bfloat162*>(a.out + off + n) =
                __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
          }
        }
      }
    }
  }
  cp_async_wait(0);   // no copy outlives the block (the tail groups are empty)
}

template <int MT, int NT>
int launch(const BasicInt8Args& a, int B, int smem, cudaStream_t stream) {
  static int raised[kMaxDevices] = {};
  const cudaError_t err = raise_smem(basic_int8_kernel<MT, NT>, smem, raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.W + a.TW - 1) / a.TW) * ((a.H + a.TH - 1) / a.TH), B);
  basic_int8_kernel<MT, NT><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// Launch one W8A8 BasicBlock on PyTorch's stream with the plan of
// int8_chain.py::basic_int8_plan: tile TH x TW, WM warps along the pixels
// with MT m16 tiles each, NT n8 tiles per warp along the channels
// ((8 / WM) * NT * 8 == C), KB bytes of K per weight slab, a ring of
// `stages` slabs, `smem` bytes.  The weights N-major (C, 9C); x and the
// weights 16-byte aligned (the wrapper checks).  A plan this file has no
// instance for, or whose numbers do not add up, returns
// cudaErrorInvalidValue; else cudaGetLastError() after the launch.
extern "C" int hrnet_basic_int8_block(const void* x, void* out, const void* inv1,
                                      const void* kq1, const void* a1, const void* c1,
                                      const void* kq2, const void* a2, const void* c2, int B,
                                      int H, int W, int C, int TH, int TW, int WM, int MT, int NT,
                                      int KB, int stages, int smem, void* stream) {
  const bool ok = C % 16 == 0 && C >= 16 && C <= 8 * kThreads &&
                  (WM == 1 || WM == 2 || WM == 4 || WM == 8) && (kWarps / WM) * NT * 8 == C &&
                  (KB == 32 || (KB == 64 && C % 64 == 0)) && stages >= 2 && stages <= 8 &&
                  TH >= 1 && TW >= 1 && TH <= H && TW <= W && smem <= kSmemLimit &&
                  smem == basic_int8_smem(C, TH, TW, KB, stages) &&
                  (WM * MT) * 16 >= (TH + 2) * (TW + 2);
  if (!ok) return (int)cudaErrorInvalidValue;
  typedef const signed char* I8;
  typedef const float* F32;
  BasicInt8Args a{static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<F32>(inv1),
                  static_cast<I8>(kq1), static_cast<F32>(a1), static_cast<F32>(c1),
                  static_cast<I8>(kq2), static_cast<F32>(a2), static_cast<F32>(c2),
                  H, W, C, TH, TW, WM, KB, stages};
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
