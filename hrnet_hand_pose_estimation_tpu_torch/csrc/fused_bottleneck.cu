// One BN-folded bottleneck block of HRNet's layer1, fused into one launch.
//
// Replaces the TPU kernel ops/pallas/fused_bottleneck.py::fused_bottleneck_chain
// (body _block_body): y = relu(conv1x1_3(relu(conv3x3_2(relu(conv1x1_1(x))))) +
// shortcut(x)), shortcut a folded 1x1 projection on block 0 and the identity
// on the others.  Activations bf16, sums f32, and the two intermediates
// t1, t2 rounded to bf16 where the TPU kernel rounds them; the 3x3's zero
// padding applies to t1, not to x.  The chain of four blocks is four
// launches of this kernel (ops/kernels/fused_bottleneck.py).  The stem
// kernel (stem_layer1.cu) is followed by the same four launches.
//
// What bounds it on the H100: layer1 does ~2.3 GFLOP per 64x64 sample, and
// four launches move ~15 MB per sample through device memory (each block's
// input and output), ~150 FLOP per byte: below the ~295 ridge, so device
// memory bounds the four-launch design (0.58 ms at B=128 against 0.30 ms of
// tensor-core time).  The first version reached neither: every weight
// fragment came from L2 inside its WMMA loop with nothing in flight, each
// 16x16 accumulator went through a shared scratch before its epilogue, and
// its 4 x 16 tiles computed conv1 on 1.75x the pixels they needed.
//
// The design (an implicit GEMM on the shared mainloop of conv_mainloop.cuh):
// one block = one sample x a TH x TW output tile (8 x 16 at 64 x 64: each
// weight slab serves 128 output pixels, conv1 runs on 1.4x of them) x all
// output channels.
// - The input halo, (TH+2) x (TW+2) pixels of Cin channels, arrives once by
//   cp.async (0 outside the image) into shared memory, pixel rows padded to
//   Cin + 8 bf16 (an odd multiple of 16 bytes, so that the 8 rows of an
//   ldmatrix phase fall on 8 bank groups).
// - conv1 (1x1) runs on the halo; its epilogue writes t1 = bf16(relu(acc +
//   b1)) from the accumulator registers to shared memory, 0 outside the
//   image.  conv2 (3x3) reads t1 by ldmatrix with per-lane row addresses (a
//   tap is an address offset, no pixel outside the tile is computed) and
//   writes t2 = bf16(relu(acc + b2)) to shared memory.  conv3 (1x1) and, on
//   block 0, the projection shortcut accumulate into one set of registers,
//   128 output channels per pass; the epilogue adds the biases and the
//   identity residual (from the staged halo) and stores y.  t1 and t2 never
//   touch device memory.
// - w1 (Cin x Cm), w2 (9 Cm x Cm), w3 (Cm x Cout) and ws (Cin x Cout) are one
//   stream of K-slabs (KS rows each; 128 output channels of w3 and ws per
//   slab) through a ring of `stages` slabs by 16-byte cp.async: conv2's
//   first slabs are in flight while conv1 finishes, and no weight is read
//   from global memory inside an MMA loop.  B fragments come from the ring
//   by ldmatrix.trans.
// - 8 warps, 4 along the pixels and 2 along the channels; products by
//   mma.sync m16n8k16 (f32 sums).  The copy loops give each thread one
//   16-byte column and step rows: no division per copy.
// The launch plan (tile, ring depth, shared memory, grid) is made in Python,
// ops/kernels/fused_bottleneck.py::bottleneck_plan; this entry checks it.
#include "conv_mainloop.cuh"

namespace hrnet {
namespace {

constexpr int kCm = 64;        // the bottleneck width (layer1's; the plan checks)
constexpr int kNChunk = 128;   // output channels of conv3 per pass
constexpr int kHaloMax = 192;  // conv1's pixels: 4 warps x 3 m16 tiles
constexpr int kTileMax = 128;  // conv2/conv3's pixels: 4 warps x 2 m16 tiles

struct BottleneckArgs {
  const bf16* x;    // (B, H, W, Cin)
  bf16* out;        // (B, H, W, Cout)
  const bf16* w1;   // (Cin, Cm)
  const float* b1;
  const bf16* w2;   // (3, 3, Cm, Cm) HWIO: K row tap * Cm + cin
  const float* b2;
  const bf16* w3;   // (Cm, Cout)
  const float* b3;
  const bf16* ws;   // (Cin, Cout) projection shortcut, or null for the identity
  const float* bs;
  int H, W, Cin, Cout;
  int TH, TW;       // output tile
  int KS;           // K rows per weight slab
  int stages;       // depth of the weight ring
};

// shared memory of a plan: x halo, t1 on the halo, t2 on the tile, weight ring
__host__ inline long bottleneck_smem(int Cin, int TH, int TW, int KS, int stages) {
  const long halo = (TH + 2L) * (TW + 2);
  return 2L * (halo * (Cin + 8) + halo * (kCm + 8) + (long)TH * TW * (kCm + 8) +
               (long)stages * KS * (kNChunk + 8));
}

// acc += A (MT m16 tiles, row addresses a[i] + a_off) x one ring slab of KS
// K rows (sb: this lane's ldmatrix.trans address in the stage, row stride
// ldb bf16); m16 tiles with ok[i] false are skipped (warp-uniform)
template <int MT, int NT>
__device__ __forceinline__ void slab_mma(float (&acc)[MT][NT][4], const unsigned (&a)[MT],
                                         const bool (&ok)[MT], unsigned a_off, unsigned sb,
                                         int ldb, int KS) {
  for (int kq = 0; kq < KS; kq += 16) {
    // every fragment load of the k step first, then the MMAs
    unsigned b[NT][2], fa[MT][4];
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      unsigned r[4];
      ldsm_x4_trans(r, sb + (kq * ldb + jp * 16) * 2);
      b[2 * jp][0] = r[0];
      b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2];
      b[2 * jp + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (ok[i]) ldsm_x4(fa[i], a[i] + a_off + kq * 2);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (!ok[i]) continue;
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) mma_bf16(acc[i][jn], fa[i], b[jn]);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.0f;
}

__global__ void __launch_bounds__(kThreads, 1) bottleneck_kernel(BottleneckArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int RW = a.TW + 2, halo_px = (a.TH + 2) * RW, tile_px = a.TH * a.TW;
  const int ldx = a.Cin + 8;                 // bf16 per x halo row
  constexpr int ldt = kCm + 8;               // per t1 / t2 row, and per conv1/conv2 slab row
  constexpr int ldw = kNChunk + 8;           // per conv3 slab row
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* t1 = xs + halo_px * ldx;
  bf16* t2 = t1 + halo_px * ldt;
  unsigned char* ring = reinterpret_cast<unsigned char*>(t2 + tile_px * ldt);
  const int stage_bytes = a.KS * ldw * 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;   // 4 warps along the pixels, 2 along the channels
  const int tiles_x = (a.W + a.TW - 1) / a.TW;
  const int x0 = (blockIdx.x % tiles_x) * a.TW, y0 = (blockIdx.x / tiles_x) * a.TH;
  const size_t img = (size_t)blockIdx.y * a.H * a.W;

  // -- the x halo by cp.async, 0 outside the image (lands with slab 0)
  {
    const int vpr = a.Cin / 8, rstep = kThreads / vpr;
    const int v = tid % vpr, r0 = tid / vpr;   // r0 >= rstep: idle copier
    if (r0 < rstep) {
      int hy = r0 / RW, hx = r0 - hy * RW;
      for (int r = r0; r < halo_px; r += rstep) {
        const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
        const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
        const bf16* src = in ? a.x + (img + (size_t)gy * a.W + gx) * a.Cin + v * 8 : a.x;
        cp_async16(smem_u32(xs + r * ldx + v * 8), src, in);
        for (hx += rstep; hx >= RW; hx -= RW) ++hy;
      }
    }
  }

  // -- the weight stream: conv1's slabs, conv2's, then per 128-channel pass
  // of conv3 its w3 slabs and (block 0) its ws slabs
  const int J1 = a.Cin / a.KS, J2 = J1 + 9 * kCm / a.KS;
  const int n3w = kCm / a.KS, n3 = n3w + (a.ws != nullptr ? a.Cin / a.KS : 0);
  const int J = J2 + (a.Cout / kNChunk) * n3;
  auto load = [&](int j, unsigned char* st) {
    const unsigned base = smem_u32(st);
    if (j < J2) {   // Cm columns: 8 vectors a row, 32 rows a pass
      const bf16* src = (j < J1 ? a.w1 + (size_t)j * a.KS * kCm
                                : a.w2 + (size_t)(j - J1) * a.KS * kCm) + (tid & 7) * 8;
      const unsigned dst = base + (tid & 7) * 16;
      for (int r = tid >> 3; r < a.KS; r += kThreads / 8)
        cp_async16(dst + r * ldt * 2, src + (size_t)r * kCm, true);
    } else {        // 128 columns of Cout: 16 vectors a row, 16 rows a pass
      const int q = j - J2, h = q / n3, jj = q - h * n3;
      const bf16* src = (jj < n3w ? a.w3 + (size_t)jj * a.KS * a.Cout
                                  : a.ws + (size_t)(jj - n3w) * a.KS * a.Cout) +
                        h * kNChunk + (tid & 15) * 8;
      const unsigned dst = base + (tid & 15) * 16;
      for (int r = tid >> 4; r < a.KS; r += kThreads / 16)
        cp_async16(dst + r * ldw * 2, src + (size_t)r * a.Cout, true);
    }
  };
  ring_prologue(ring, stage_bytes, a.stages, J, load);

  // -- conv1 on the halo: t1 = bf16(relu(x @ w1 + b1)), 0 outside the image
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
      al[i] = smem_u32(xs + p * ldx + (lane >> 4) * 8);
    }
    const unsigned bl = ((lane & 15) * ldt + n0 + (lane >> 4) * 8) * 2;
    float acc[MT][NT][4];
    zero(acc);
    ring_run(ring, stage_bytes, a.stages, J, 0, J1, load, [&](int j, unsigned char* st) {
      slab_mma<MT, NT>(acc, al, ok, j * a.KS * 2, smem_u32(st) + bl, ldt, a.KS);
    });
    float bias[NT][2];
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const float2 bb = *reinterpret_cast<const float2*>(a.b1 + n0 + jn * 8 + 2 * t4);
      bias[jn][0] = bb.x;
      bias[jn][1] = bb.y;
    }
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
        bf16* dst = t1 + p * ldt + n0 + 2 * t4;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          const float v0 = in ? fmaxf(acc[i][jn][2 * h] + bias[jn][0], 0.0f) : 0.0f;
          const float v1 = in ? fmaxf(acc[i][jn][2 * h + 1] + bias[jn][1], 0.0f) : 0.0f;
          *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) = __floats2bfloat162_rn(v0, v1);
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
  // t2 = bf16(relu(conv2(t1) + b2))
  {
    constexpr int NT = 4;
    const int n0 = wn * 32;
    unsigned al[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int py = tp[i] / a.TW, px = tp[i] - py * a.TW;
      al[i] = smem_u32(t1 + (py * RW + px) * ldt + (lane >> 4) * 8);
    }
    const unsigned bl = ((lane & 15) * ldt + n0 + (lane >> 4) * 8) * 2;
    float acc[MT][NT][4];
    zero(acc);
    ring_run(ring, stage_bytes, a.stages, J, J1, J2, load, [&](int j, unsigned char* st) {
      const int k0 = (j - J1) * a.KS;   // K row: tap * Cm + channel
      const int tap = k0 / kCm, c0 = k0 - tap * kCm;
      const unsigned off = (((tap / 3) * RW + tap % 3) * ldt + c0) * 2;
      slab_mma<MT, NT>(acc, al, ok, off, smem_u32(st) + bl, ldt, a.KS);
    });
    float bias[NT][2];
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const float2 bb = *reinterpret_cast<const float2*>(a.b2 + n0 + jn * 8 + 2 * t4);
      bias[jn][0] = bb.x;
      bias[jn][1] = bb.y;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wm + 4 * i) * 16 + g + 8 * h;
        if (p >= tile_px) continue;
        bf16* dst = t2 + p * ldt + n0 + 2 * t4;
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
          *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) = __floats2bfloat162_rn(
              fmaxf(acc[i][jn][2 * h] + bias[jn][0], 0.0f),
              fmaxf(acc[i][jn][2 * h + 1] + bias[jn][1], 0.0f));
      }
    }
  }

  // -- conv3 + shortcut, 128 output channels a pass:
  // y = bf16(relu(t2 @ w3 + x @ ws + b3 + bs))  or  bf16(relu(t2 @ w3 + b3 + x))
  {
    constexpr int NT = 8;
    const int n0 = wn * 64;   // the warp's first channel inside the pass
    unsigned at[MT], ax[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int py = tp[i] / a.TW, px = tp[i] - py * a.TW;
      at[i] = smem_u32(t2 + tp[i] * ldt + (lane >> 4) * 8);
      ax[i] = smem_u32(xs + ((py + 1) * RW + px + 1) * ldx + (lane >> 4) * 8);
    }
    const unsigned bl = ((lane & 15) * ldw + n0 + (lane >> 4) * 8) * 2;
    for (int pass = 0; pass < a.Cout / kNChunk; ++pass) {
      float acc[MT][NT][4];
      zero(acc);
      const int jb = J2 + pass * n3;
      ring_run(ring, stage_bytes, a.stages, J, jb, jb + n3, load, [&](int j, unsigned char* st) {
        const int jj = j - jb;
        if (jj < n3w)
          slab_mma<MT, NT>(acc, at, ok, jj * a.KS * 2, smem_u32(st) + bl, ldw, a.KS);
        else
          slab_mma<MT, NT>(acc, ax, ok, (jj - n3w) * a.KS * 2, smem_u32(st) + bl, ldw, a.KS);
      });
      const int nc = pass * kNChunk + n0 + 2 * t4;   // this lane's first output channel
      float bias[NT][2];
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const float2 bb = *reinterpret_cast<const float2*>(a.b3 + nc + jn * 8);
        bias[jn][0] = bb.x;
        bias[jn][1] = bb.y;
        if (a.ws != nullptr) {
          const float2 bp = *reinterpret_cast<const float2*>(a.bs + nc + jn * 8);
          bias[jn][0] += bp.x;
          bias[jn][1] += bp.y;
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (wm + 4 * i) * 16 + g + 8 * h;
          if (p >= tile_px) continue;
          const int py = p / a.TW, px = p - py * a.TW;
          const int gy = y0 + py, gx = x0 + px;
          if (gy >= a.H || gx >= a.W) continue;
          const bf16* res = xs + ((py + 1) * RW + px + 1) * ldx + nc;
          bf16* dst = a.out + (img + (size_t)gy * a.W + gx) * a.Cout + nc;
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            float v0 = acc[i][jn][2 * h] + bias[jn][0];
            float v1 = acc[i][jn][2 * h + 1] + bias[jn][1];
            if (a.ws == nullptr) {   // identity: Cin == Cout
              const float2 r =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + jn * 8));
              v0 += r.x;
              v1 += r.y;
            }
            *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) =
                __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
          }
        }
      }
    }
  }
  cp_async_wait(0);   // no copy outlives the block (the tail groups are empty)
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// Launch one folded bottleneck on PyTorch's stream with the plan of
// fused_bottleneck.py::bottleneck_plan: tile TH x TW, KS K rows per weight
// slab, a ring of `stages` slabs, `smem` bytes.  Cm == 64, Cin % KS == 0,
// Cout % 128 == 0, Cin == Cout without a projection (ws null), pointers
// 16-byte aligned (the wrapper checks).  A plan whose numbers do not add up
// returns cudaErrorInvalidValue; else cudaGetLastError() after the launch.
extern "C" int hrnet_bottleneck_block(const void* x, void* out, const void* w1, const void* b1,
                                      const void* w2, const void* b2, const void* w3,
                                      const void* b3, const void* ws, const void* bs, int B,
                                      int H, int W, int Cin, int Cm, int Cout, int TH, int TW,
                                      int KS, int stages, int smem, void* stream) {
  const bool ok = Cm == kCm && (KS == 32 || KS == 64) && Cin % KS == 0 && Cin <= 8 * kThreads &&
                  Cout % kNChunk == 0 && (ws != nullptr || Cin == Cout) && TH >= 1 && TW >= 1 &&
                  TH <= H && TW <= W && (TH + 2) * (TW + 2) <= kHaloMax &&
                  TH * TW <= kTileMax && stages >= 2 && stages <= 8 && smem <= kSmemLimit &&
                  smem == bottleneck_smem(Cin, TH, TW, KS, stages);
  if (!ok) return (int)cudaErrorInvalidValue;
  BottleneckArgs a{static_cast<const bf16*>(x),  static_cast<bf16*>(out),
                   static_cast<const bf16*>(w1), static_cast<const float*>(b1),
                   static_cast<const bf16*>(w2), static_cast<const float*>(b2),
                   static_cast<const bf16*>(w3), static_cast<const float*>(b3),
                   static_cast<const bf16*>(ws), static_cast<const float*>(bs),
                   H, W, Cin, Cout, TH, TW, KS, stages};
  static int raised[kMaxDevices] = {};
  const cudaError_t err = raise_smem(bottleneck_kernel, smem, raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((W + TW - 1) / TW) * ((H + TH - 1) / TH), B);
  bottleneck_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* hrnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
