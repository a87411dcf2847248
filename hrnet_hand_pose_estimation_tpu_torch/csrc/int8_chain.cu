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
// own rule; the per-site walk and conv_int8.cu divide), rounding is half to
// even (rintf), the clip is to +-127, every a*acc + c rounds the product and
// the sum separately (__fmul_rn, __fadd_rn: no FMA contraction), and the
// residual is the bf16 block input in f32, not xq.  The int32 sums are exact
// in any order.
//
// What bounds it on the H100: at B=128 the chain does ~297 G int8
// operations (~0.15 ms at 1979 TOPS dense), while four launches move each
// block's bf16 input and output through device memory (~0.58 ms at
// 3.35 TB/s): the four-launch design is bound by bytes.
//
// The design (an implicit GEMM on the shared mainloop of conv_mainloop.cuh,
// the structure of the bf16 block kernel fused_bottleneck.cu with the int8
// operands of conv_int8.cu): one block = one sample x a TH x TW output tile
// (8 x 16 at 64 x 64 on a 10 x 18 halo) x all output channels.  The kernel
// takes layer1's two block classes and no other: Cin 64 or 256, Cm 64,
// Cout 256.
// - The x halo is quantized once into shared memory, int8 rows of Cin + 16
//   bytes (an odd multiple of 16), 0 outside the image.
// - conv1 (1x1) runs on the halo; its requant epilogue writes t1 from the
//   accumulator registers, 0 outside the image (the 3x3's zero padding
//   applies to t1).  conv2 (3x3) reads t1 by ldmatrix with per-lane row
//   addresses (a tap is an address offset) and writes t2.  conv3 and, on
//   block 0, the projection accumulate per pass of NP output channels into
//   two sets of registers (their scales differ); the epilogue dequantizes,
//   adds the shortcut and stages y in shared memory, whence it is stored by
//   16-byte vectors.  The identity residual, the bf16 block input, arrives
//   by cp.async into those staging rows (over the x halo, free after conv1;
//   at Cin == Cout == 256 a staged row of 136 bf16 is the halo's 272-byte
//   row, and the tile has fewer pixels than its halo) while the pass
//   multiplies.  t1 and t2 never touch device memory.
// - The weights arrive N-major (prepare_layer1_int8 stores each kq as the
//   (K, N) view of (N, K) storage), so B comes from the ring by ldmatrix
//   without .trans (which moves 16-bit elements and cannot transpose int8).
//   w1, w2, w3 and ws form one stream of K-slabs (64 bytes of K x 64 or NP
//   rows) through a ring of `stages` slabs by 16-byte cp.async: conv2's
//   first slabs are in flight while conv1 finishes, and no weight is read
//   from global memory inside an MMA loop.
// - 8 warps, 4 along the pixels and 2 along the channels.  At Cin 256 a
//   block takes 114,560 bytes of shared memory, so two blocks share an SM
//   (one's loads and epilogues overlap the other's MMAs).
// The launch plan (tile, ring depth, shared memory, grid) is made in
// Python, ops/kernels/int8_chain.py::int8_bottleneck_plan; this entry
// checks it.
#include "conv_mainloop.cuh"

namespace hrnet {
namespace {

constexpr int kCm = 64;        // the bottleneck width
constexpr int kCout = 256;     // the block's output channels
constexpr int kKB = 64;        // bytes of K per weight slab
constexpr int kHaloMax = 192;  // conv1's pixels: 4 warps x 3 m16 tiles
constexpr int kTileMax = 128;  // conv2/conv3's pixels: 4 warps x 2 m16 tiles
constexpr int kLdt = kCm + 16; // bytes per t1 / t2 row

struct Int8BlockArgs {
  const bf16* x;            // (B, H, W, Cin)
  bf16* out;                // (B, H, W, Cout)
  const float* inv1;        // () 1/sa1
  const signed char* w1;    // kq1 N-major: (Cm, Cin)
  const float *a1, *c1;     // (Cm,)
  const signed char* w2;    // kq2 N-major: (Cm, 9 Cm), K = tap * Cm + ci
  const float *a2, *c2;     // (Cm,)
  const signed char* w3;    // kq3 N-major: (Cout, Cm)
  const float *a3, *c3;     // (Cout,)
  const signed char* ws;    // kqs N-major: (Cout, Cin), or null for the identity
  const float *as, *cs;     // (Cout,)
  int H, W, Cin;            // Cin 64 or 256
  int TH, TW;               // output tile
  int stages;               // depth of the weight ring
};

// output channels of conv3 per pass: 64 with a projection (two sets of
// accumulators), else 128
__host__ __device__ constexpr int pass_channels(bool proj) { return proj ? 64 : 128; }

// bytes of y's staging rows for one pass: the tile's pixels x (NP + 8) bf16
__host__ __device__ inline int staging_bytes(bool proj, int tile_px) {
  return tile_px * (pass_channels(proj) + 8) * 2;
}

// shared memory of a plan: x halo (with the identity it also holds y's
// staging rows, conv1 being done with it by then), t1 on the halo, t2 on
// the tile, weight ring and, with the projection, y's staging rows
__host__ inline long int8_bottleneck_smem(int Cin, bool proj, int TH, int TW, int stages) {
  const int halo = (TH + 2) * (TW + 2), tile = TH * TW;
  const int rows = pass_channels(proj) > kCm ? pass_channels(proj) : kCm;
  return (long)halo * pitch_s8(Cin) + (long)(halo + tile) * kLdt +
         (long)stages * rows * (kKB + 16) + (proj ? staging_bytes(proj, tile) : 0);
}

template <bool kProj>
__global__ void __launch_bounds__(kThreads, 2) bottleneck_int8_kernel(Int8BlockArgs a) {
  constexpr int NP = pass_channels(kProj);
  extern __shared__ __align__(128) unsigned char smem[];
  const int RW = a.TW + 2, halo_px = (a.TH + 2) * RW, tile_px = a.TH * a.TW;
  const int ldx = pitch_s8(a.Cin);
  constexpr int rowb = kKB + 16;                   // bytes per ring row
  signed char* xs = reinterpret_cast<signed char*>(smem);
  signed char* t1 = xs + halo_px * ldx;
  signed char* t2 = t1 + halo_px * kLdt;
  unsigned char* ring = reinterpret_cast<unsigned char*>(t2 + tile_px * kLdt);
  constexpr int stage_bytes = (NP > kCm ? NP : kCm) * rowb;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;   // 4 warps along the pixels, 2 along the channels
  const int tiles_x = (a.W + a.TW - 1) / a.TW;
  const int x0 = (blockIdx.x % tiles_x) * a.TW, y0 = (blockIdx.x / tiles_x) * a.TH;
  const size_t img = (size_t)blockIdx.y * a.H * a.W;

  // -- the weight stream: conv1's slabs, conv2's, then per pass of NP
  // output channels its w3 slabs and (block 0) its ws slabs.  Each thread
  // copies one 16-byte column of a slab row and steps rows: no division per
  // copy.
  const int J1 = a.Cin / kKB, J2 = J1 + 9 * kCm / kKB;
  constexpr int n3w = kCm / kKB;
  const int n3 = n3w + (kProj ? a.Cin / kKB : 0);
  const int J = J2 + (kCout / NP) * n3;
  constexpr int cpr = kKB / 16, rstep = kThreads / cpr;
  const int part = tid % cpr, r0 = tid / cpr;
  auto load = [&](int j, unsigned char* st) {
    const signed char* src;
    int rows, ld;
    if (j < J1) {
      src = a.w1 + j * kKB;
      rows = kCm;
      ld = a.Cin;
    } else if (j < J2) {
      src = a.w2 + (j - J1) * kKB;
      rows = kCm;
      ld = 9 * kCm;
    } else {
      const int q = j - J2, h = q / n3, jj = q - h * n3;
      if (jj < n3w) {
        src = a.w3 + (size_t)h * NP * kCm + jj * kKB;
        ld = kCm;
      } else {
        src = a.ws + (size_t)h * NP * a.Cin + (jj - n3w) * kKB;
        ld = a.Cin;
      }
      rows = NP;
    }
    src += part * 16;
    const unsigned dst = smem_u32(st) + part * 16;
    for (int r = r0; r < rows; r += rstep) cp_async16(dst + r * rowb, src + (size_t)r * ld, true);
  };
  ring_prologue(ring, stage_bytes, a.stages, J, load);

  // -- the x halo, quantized once while the first slabs are in flight (the
  // first barrier of conv1's ring_run publishes it)
  quantize_window(xs, ldx, a.x + img * a.Cin, a.H, a.W, a.Cin, y0 - 1, x0 - 1, RW, halo_px,
                  *a.inv1);

  // -- conv1 on the halo: t1 = requant(xq @ kq1), 0 outside the image
  {
    constexpr int MT = 3, NT = 4;
    const int n0 = wn * 32;
    unsigned al[MT];
    bool ok[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = (wm + 4 * i) * 16;
      ok[i] = m < halo_px;
      int p = m + (lane & 15);
      if (p >= halo_px) p = 0;   // rows past the halo: computed, never stored
      al[i] = a_lane_s8(xs, p, ldx, lane);
    }
    const unsigned bl = b_lane_s8(n0, rowb, lane);
    int acc[MT][NT][4];
    zero_s32(acc);
    ring_run(ring, stage_bytes, a.stages, J, 0, J1, load, [&](int j, unsigned char* st) {
      slab_mma_s8<MT, NT>(acc, al, ok, j * kKB, smem_u32(st) + bl, rowb, kKB);
    });
    // c0, c1 at row g, c2, c3 at row g + 8, columns 2 * t4 and 2 * t4 + 1 of each n8 tile
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wm + 4 * i) * 16 + g + 8 * h;
        if (p >= halo_px) continue;
        const int py = p / RW, px = p - py * RW;
        const int gy = y0 - 1 + py, gx = x0 - 1 + px;
        const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const int n = n0 + jn * 8 + 2 * t4;
          const float2 s = *reinterpret_cast<const float2*>(a.a1 + n);
          const float2 c = *reinterpret_cast<const float2*>(a.c1 + n);
          store_s8x2(t1 + p * kLdt + n, in ? requant_s8(acc[i][jn][2 * h], s.x, c.x) : 0,
                     in ? requant_s8(acc[i][jn][2 * h + 1], s.y, c.y) : 0);
        }
      }
    }
  }

  // the tile pixels of each lane's A rows in conv2 and conv3
  constexpr int MT = 2;
  int tp[MT];
  bool ok[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = (wm + 4 * i) * 16;
    ok[i] = m < tile_px;
    tp[i] = m + (lane & 15);
    if (tp[i] >= tile_px) tp[i] = 0;
  }

  // -- conv2 (3x3 on t1; the first barrier of its ring_run publishes t1):
  // t2 = requant(conv2(t1))
  {
    constexpr int NT = 4;
    const int n0 = wn * 32;
    unsigned al[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int py = tp[i] / a.TW, px = tp[i] - py * a.TW;
      al[i] = a_lane_s8(t1, py * RW + px, kLdt, lane);
    }
    const unsigned bl = b_lane_s8(n0, rowb, lane);
    int acc[MT][NT][4];
    zero_s32(acc);
    ring_run(ring, stage_bytes, a.stages, J, J1, J2, load, [&](int j, unsigned char* st) {
      const int k0 = (j - J1) * kKB;   // K: tap * Cm + channel
      const int tap = k0 / kCm, c0 = k0 - tap * kCm;
      const unsigned off = ((tap / 3) * RW + tap % 3) * kLdt + c0;
      slab_mma_s8<MT, NT>(acc, al, ok, off, smem_u32(st) + bl, rowb, kKB);
    });
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wm + 4 * i) * 16 + g + 8 * h;
        if (p >= tile_px) continue;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const int n = n0 + jn * 8 + 2 * t4;
          const float2 s = *reinterpret_cast<const float2*>(a.a2 + n);
          const float2 c = *reinterpret_cast<const float2*>(a.c2 + n);
          store_s8x2(t2 + p * kLdt + n, requant_s8(acc[i][jn][2 * h], s.x, c.x),
                     requant_s8(acc[i][jn][2 * h + 1], s.y, c.y));
        }
      }
    }
  }

  // -- conv3 + shortcut, NP output channels a pass:
  // y = bf16(relu((a3 * (t2 @ kq3) + c3) + (as * (xq @ kqs) + cs  |  float(x))))
  // y is staged in shared memory, rows of NP + 8 bf16, and stored by 16-byte
  // vectors, consecutive threads on consecutive bytes of a pixel.  With the
  // identity shortcut the staging rows lie over the x halo (free after
  // conv1), where the pass's residual tile arrives by cp.async while the
  // pass multiplies; with the projection they have a region of their own.
  {
    constexpr int NT = NP / 16;
    constexpr int lds = NP + 8;     // bf16 per staged pixel row
    constexpr int cpp = NP / 8;     // 16-byte vectors per staged pixel row
    constexpr int qstep = kThreads / cpp;
    bf16* ys = reinterpret_cast<bf16*>(kProj ? ring + a.stages * stage_bytes
                                             : reinterpret_cast<unsigned char*>(xs));
    const int n0 = wn * (NP / 2);   // the warp's first channel inside the pass
    const int vec = tid % cpp, q0 = tid / cpp;
    unsigned at[MT], ax[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int py = tp[i] / a.TW, px = tp[i] - py * a.TW;
      at[i] = a_lane_s8(t2, tp[i], kLdt, lane);
      ax[i] = a_lane_s8(xs, (py + 1) * RW + px + 1, ldx, lane);
    }
    const unsigned bl = b_lane_s8(n0, rowb, lane);
    // the image pixel of tile pixel q, or false outside the image
    auto pixel = [&](int q, size_t& pix) {
      const int py = q / a.TW, gy = y0 + py, gx = x0 + q - py * a.TW;
      pix = img + (size_t)gy * a.W + gx;
      return gy < a.H && gx < a.W;
    };
    for (int pass = 0; pass < kCout / NP; ++pass) {
      const int c0 = pass * NP + vec * 8;   // this thread's 8 channels of the staged rows
      if constexpr (!kProj) {
        __syncthreads();   // every thread is done with the rows of the pass before
        for (int q = q0; q < tile_px; q += qstep) {
          size_t pix;
          const bool in = pixel(q, pix);
          cp_async16(smem_u32(ys + q * lds + vec * 8), in ? a.x + pix * a.Cin + c0 : a.x, in);
        }
        cp_async_commit();
      }
      int acc[MT][NT][4], accs[kProj ? MT : 1][kProj ? NT : 1][4];
      zero_s32(acc);
      zero_s32(accs);
      const int jb = J2 + pass * n3;
      ring_run(ring, stage_bytes, a.stages, J, jb, jb + n3, load, [&](int j, unsigned char* st) {
        const int jj = j - jb;
        if constexpr (kProj) {
          if (jj >= n3w) {
            slab_mma_s8<MT, NT>(accs, ax, ok, (jj - n3w) * kKB, smem_u32(st) + bl, rowb, kKB);
            return;
          }
        }
        slab_mma_s8<MT, NT>(acc, at, ok, jj * kKB, smem_u32(st) + bl, rowb, kKB);
      });
      if constexpr (!kProj) {
        cp_async_wait(n3);   // the residual tile: the pass's n3 slab groups are newer
        __syncthreads();
      }
      // (with the projection, the first barrier of this pass's ring_run
      // ordered the stores of the pass before ahead of these writes)
      const int nc = pass * NP + n0 + 2 * t4;   // this lane's first output channel
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (wm + 4 * i) * 16 + g + 8 * h;
          if (p >= tile_px) continue;
          bf16* row = ys + p * lds + n0 + 2 * t4;
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            const int n = nc + jn * 8;
            const float2 s3 = *reinterpret_cast<const float2*>(a.a3 + n);
            const float2 c3 = *reinterpret_cast<const float2*>(a.c3 + n);
            float2 sc;
            if constexpr (kProj) {
              const float2 ss = *reinterpret_cast<const float2*>(a.as + n);
              const float2 cs = *reinterpret_cast<const float2*>(a.cs + n);
              sc = make_float2(dequant(accs[i][jn][2 * h], ss.x, cs.x),
                               dequant(accs[i][jn][2 * h + 1], ss.y, cs.y));
            } else {   // identity (Cin == Cout): the staged residual, overwritten by y
              sc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + jn * 8));
            }
            const float v0 = __fadd_rn(dequant(acc[i][jn][2 * h], s3.x, c3.x), sc.x);
            const float v1 = __fadd_rn(dequant(acc[i][jn][2 * h + 1], s3.y, c3.y), sc.y);
            *reinterpret_cast<__nv_bfloat162*>(row + jn * 8) =
                __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
          }
        }
      }
      __syncthreads();
      for (int q = q0; q < tile_px; q += qstep) {
        size_t pix;
        if (pixel(q, pix))
          *reinterpret_cast<uint4*>(a.out + pix * kCout + c0) =
              *reinterpret_cast<const uint4*>(ys + q * lds + vec * 8);
      }
    }
  }
  cp_async_wait(0);   // no copy outlives the block (the tail groups are empty)
}

template <bool kProj>
int launch(const Int8BlockArgs& a, int B, int smem, cudaStream_t stream) {
  static int raised[kMaxDevices] = {};
  const cudaError_t err = raise_smem(bottleneck_int8_kernel<kProj>, smem, raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.W + a.TW - 1) / a.TW) * ((a.H + a.TH - 1) / a.TH), B);
  bottleneck_int8_kernel<kProj><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// Launch one W8A8 bottleneck on PyTorch's stream with the plan of
// int8_chain.py::int8_bottleneck_plan: tile TH x TW, a ring of `stages`
// weight slabs, `smem` bytes.  The weights N-major (kq1 (Cm, Cin), kq2
// (Cm, 9 Cm), kq3 (Cout, Cm), kqs (Cout, Cin)); Cin 64 or 256, Cm 64,
// Cout 256, Cin == Cout without a projection (kqs null), x and the weights
// 16-byte aligned (the wrapper checks).  A plan whose numbers do not add
// up returns cudaErrorInvalidValue; else cudaGetLastError() after the
// launch.
extern "C" int hrnet_bottleneck_int8_block(const void* x, void* out, const void* inv1,
                                           const void* kq1, const void* a1, const void* c1,
                                           const void* kq2, const void* a2, const void* c2,
                                           const void* kq3, const void* a3, const void* c3,
                                           const void* kqs, const void* as, const void* cs,
                                           int B, int H, int W, int Cin, int Cm, int Cout,
                                           int TH, int TW, int stages, int smem, void* stream) {
  const bool proj = kqs != nullptr;
  const bool ok = Cm == kCm && (Cin == 64 || Cin == 256) && Cout == kCout &&
                  (proj || Cin == Cout) && TH >= 1 && TW >= 1 && TH <= H && TW <= W &&
                  (TH + 2) * (TW + 2) <= kHaloMax && TH * TW <= kTileMax && stages >= 2 &&
                  stages <= 4 && smem == int8_bottleneck_smem(Cin, proj, TH, TW, stages);
  if (!ok) return (int)cudaErrorInvalidValue;
  typedef const signed char* I8;
  typedef const float* F32;
  Int8BlockArgs a{static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<F32>(inv1),
                  static_cast<I8>(kq1), static_cast<F32>(a1), static_cast<F32>(c1),
                  static_cast<I8>(kq2), static_cast<F32>(a2), static_cast<F32>(c2),
                  static_cast<I8>(kq3), static_cast<F32>(a3), static_cast<F32>(c3),
                  static_cast<I8>(kqs), static_cast<F32>(as), static_cast<F32>(cs),
                  H, W, Cin, TH, TW, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return proj ? launch<true>(a, B, smem, s) : launch<false>(a, B, smem, s);
}
