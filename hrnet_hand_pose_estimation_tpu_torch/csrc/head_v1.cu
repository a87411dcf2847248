// HRNet's head, first version: upsample, then the head convs at full
// resolution, then the spatial softmax and soft-argmax, in one launch.
//
// Replaces the TPU kernel ops/pallas/fused_head_decode.py::fused_head_decode
// (v1, body _kernel).  Per sample, on square maps (h0 = w0):
//   up_i   = bf16(x_i @ bf16(kron(W_i, W_i)^T))   branches 1..3, f32 sums
//   feat   = concat(x_0, up_1, up_2, up_3)        (Ctot = 480 for w32)
//   y      = bf16(relu(feat @ w_head + b_head))
//   logits = (y @ w_final + b_final) * temp
//   coords = sum_p softmax_p(logits) * (p % W0, p / W0)      -> (B, K, 2)
//
// The dense Kronecker matrix is not carried over: row p = (py, px) of it
// has at most four nonzero entries, bf16(f32(W[py, sy] * W[px, sx])) for sy
// in {lo_y, hi_y} and sx in {lo_x, hi_x}, so each upsampled pixel is a
// gather of four taps whose weights are exactly those entries, summed in f32
// and rounded to bf16.  Only the order of the f32 sum differs from the
// dense product (whose other terms are products with 0).
//
// What bounds it on the H100: ~1.97 GFLOP per sample of bf16 products (the
// Ctot x N head conv and the N -> K final conv at 64 x 64) against ~0.5 MB
// of branch tensors in: the tensor cores.  But every tile of 128 pixels
// multiplies all of w_head (460 KB at w32, 128 FLOP per weight byte)
// streamed through shared memory, and a wgmma of N = 96 reads ~5 KB of
// operands per 196 KFLOP: measured (PERF.md), a block is held by the
// tensor cores, the weight ring's latency (four 12 KB stages fit beside the
// 128 KB feat tile and the staged rows) and the feat build, not by L2.  The
// design:
//
// - Grid (cluster, B): a thread-block cluster of up to 8 blocks per sample,
//   each walking `tiles` tiles of 64 * wgs pixels (wgs = 2 consumer
//   warpgroups of 64 rows each; 1 where the feat tile of 128 rows does not
//   fit, as at w40 and w48).  One block per SM (~220 KB of shared memory).
// - Per tile, a staging warp copies the source rows of branches 1..3 that
//   the tile's taps reach into shared memory (one bulk copy each,
//   contiguous in NHWC), while the previous tile multiplies.  Each consumer
//   warpgroup then builds its 64 x Ctot feat rows once, in the
//   128-byte-swizzled K-major layout that wgmma reads through a descriptor
//   (K blocks of 64 columns, rows of 128 bytes): x_0 copied by 16-byte
//   cp.async from device memory, branches 1..3 gathered from their four
//   staged taps, 8 channels per thread.  (Gathered from L2 instead, by 8
//   warps per SM, the build took 44 % of a block's cycles.)  The build is
//   not overlapped with the GEMM.
// - w_head, laid out by the wrapper as slabs of 96 head columns x 64 feat
//   columns (12 KB, the same swizzle), and per 96-column chunk the chunk's
//   rows of w_final (32 joints x 96, 8 KB), stream through a ring of
//   `stages` slabs completing on mbarriers.  A producer warp issues them,
//   each block its own: a ring shared by the cluster (each slab multicast
//   to every block) measured slower on the H100 (PERF.md), since L2 is not
//   what bounds the ring and the cluster then waits for its slowest block
//   at every slab.
// - The head GEMM runs on wgmma.mma_async m64n96k16 (bf16 -> f32, A and B
//   from shared memory), 48 accumulators per thread per chunk.  After each
//   chunk: bias, ReLU and bf16 in registers, and the accumulators become the
//   register A operand of a second wgmma (m64n32k16 per group of 32 joints)
//   that adds y_chunk @ w_final[chunk] into the logits.  y and the logits
//   never leave the chip.
// - Per tile, each warp forms per joint the max, sum e, sum e*u and sum e*v
//   of its 16 rows (warp shuffles), merged into the block's state in shared
//   memory; the cluster combines its blocks' states through distributed
//   shared memory and rank 0 divides once and writes (B, K, 2).
//
// Widths: the wrapper pads each branch's channels to a multiple of 8 (zero
// channels, feat columns off_i .. off_i + C_i), Ctot to a multiple of 16
// and N to a multiple of 96 with zero rows and columns of the weights and a
// zero bias (relu(0) * 0 adds exact zeros); K <= 128 in up to 4 groups of
// 32.  The launch plan (warpgroups, tiles, cluster, ring depth, staged
// rows, shared memory) is made in Python, ops/kernels/fused_head_decode.py::
// head_v1_plan; the entry checks it.
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "conv_mainloop.cuh"

namespace hrnet {
namespace {

namespace cg = cooperative_groups;

constexpr int kNC = 96;                 // head columns per chunk: the head wgmma's N
constexpr int kSlab = kNC * 128;        // bytes of one ring stage: 96 rows of 64 bf16
constexpr int kKBlock = 64 * 128;       // bytes of one K block of 64 feat rows
constexpr int kJG = 32;                 // joints per group: the final wgmma's N
constexpr int kMaxKG = 4;               // K <= 128
constexpr int kFinalSlab = 2 * kJG * 128;   // a chunk's w_final rows of one group: 2 K blocks
constexpr int kConsumerWarps = 8;       // two warpgroups
constexpr int kRingWarp = kConsumerWarps;           // issues the weight slabs
constexpr int kStageWarp = kConsumerWarps + 1;      // issues the branch rows of each tile
constexpr int kThreadsV1 = (kConsumerWarps + 2) * 32;
constexpr int kMaxCluster = 8;          // the portable cluster size

struct V1Args {
  const bf16* x[4];       // (B, s_i, s_i, C_i) NHWC, C_i % 8 == 0; s_0 = H0
  const bf16* wstream;    // per chunk: nkb w_head slabs, then KG w_final slabs (kSlab bytes each)
  const float* b_head;    // (Np), zero past N
  const float* b_final;   // (K)
  const float* temp;      // ()
  const float* taps;      // (3 branches, 4 fields {lo, hi, wa, wb}, H0)
  float* out;             // (B, K, 2)
  int H0, HW;
  int s[4], C[4];
  int off[5];             // feat column of each branch; off[4] = Ctot padded to 16
  int Np, K, KG, nkb, nch;
  int wgs, tiles, cluster, stages;
  int SR[4];              // source rows of branches 1..3 a tile stages, at most
  // shared-memory layout, bytes from the 1024-aligned base; the staged rows
  // of a tile: branch i's source rows at st_off[i]
  int off_a, off_ring, off_stage, off_taps, off_bh, off_bf, off_part, off_bpart, off_full,
      off_empty, off_sbar;
  int st_off[4];
  int smem;
};

__host__ __device__ inline int take128(int v) { return (v + 127) / 128 * 128; }

// The shared-memory layout of a plan (fused_head_decode.py::_v1_smem computes
// the same total): the feat tiles (wgs x nkb K blocks of 64 rows x 128
// bytes), the ring, a tile's staged branch rows, the row taps, b_head,
// b_final, the warps' and the block's softmax states, the ring's full and
// empty mbarriers and the staging's two; 1024 bytes of slack to align the
// base for the 128-byte swizzle.
__host__ inline void v1_layout(V1Args& a) {
  int o = 0;
  auto take = [&](int bytes) {
    const int at = o;
    o += take128(bytes);
    return at;
  };
  a.off_a = take(a.wgs * a.nkb * kKBlock);
  a.off_ring = take(a.stages * kSlab);
  int st = 0;
  a.st_off[0] = 0;
  for (int i = 1; i < 4; ++i) {
    a.st_off[i] = st;
    st += take128(a.SR[i] * a.s[i] * a.C[i] * 2);
  }
  a.off_stage = take(st);
  a.off_taps = take(12 * a.H0 * 4);
  a.off_bh = take(a.Np * 4);
  a.off_bf = take(a.KG * kJG * 4);
  a.off_part = take(kConsumerWarps * a.KG * kJG * 16);
  a.off_bpart = take(a.KG * kJG * 16);
  a.off_full = take(8 * a.stages);
  a.off_empty = take(8 * a.stages);
  a.off_sbar = take(16);
  a.smem = o + 1024;
}

// ---- wgmma: 64-row warpgroup products, operands in shared memory through
// descriptors (or A in registers), f32 accumulators in registers

// K-major operand in the 128-byte swizzle: rows of 128 bytes (64 bf16),
// 16-byte piece q of row r stored at q ^ (r % 8), 8-row groups 1024 bytes
// apart (SBO); the leading offset is unused for this layout.  A k16 step
// within the 64 columns advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of an accumulator across a wait
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (64 x 96 per warpgroup) += A (64 x 16) * B (16 x 96), both from shared memory
__device__ __forceinline__ void wgmma_head(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32 per warpgroup) += A (64 x 16, bf16 pairs in registers in the
// accumulator layout of a 16-column slice) * B (16 x 32) from shared memory
__device__ __forceinline__ void wgmma_final(float (&d)[16], unsigned a0, unsigned a1, unsigned a2,
                                            unsigned a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// ---- the ring

__device__ __forceinline__ void mbar_arrive(unsigned addr) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(addr) : "memory");
}

// A ring's position: stage st of `stages`, and the parity of the stage's
// use (slab j is at stage j % stages, use j / stages), stepped without
// dividing
struct RingPos {
  int st = 0, ph = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
  }
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// shared-memory writes of the threads made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The first source row of branch i (1..3) a tile starting at pixel p0
// stages: the lower row tap of its first image row
__device__ __forceinline__ int first_row(const V1Args& a, const float* taps, int i, int p0) {
  return (int)taps[(i - 1) * 4 * a.H0 + p0 / a.H0];
}

// Feat rows row0 .. row0 + 63 of the tile of sample b that starts at pixel
// p0 into the K-major 128-byte swizzle: piece q (columns 8q .. 8q + 7) of
// row r at K block q / 8, position (q % 8) ^ (r % 8).  x_0's columns are
// copied from device memory; an upsampled branch's are, from the tile's
// staged rows, the sum of four taps, each
// weight the kron_interp entry (one f32 product of the row and column taps,
// rounded to bf16), summed in f32 and rounded to bf16; padding columns and
// rows past the map are zero.  Two threads per row, each every other piece:
// a branch's four tap offsets and weights are made once per row.
__device__ inline void build_feat(const V1Args& a, const float* taps, const unsigned char* stage,
                                  int b, int p0, int row0, unsigned char* as, int t128) {
  const int r = t128 >> 1, half = t128 & 1, p = row0 + r, H0 = a.H0;
  unsigned char* row = as + r * 128;
  auto put = [&](int q, uint4 val) {
    *reinterpret_cast<uint4*>(row + (q >> 3) * kKBlock + (((q & 7) ^ (r & 7)) << 4)) = val;
  };
  if (p >= a.HW) {
    for (int q = half; q < a.off[4] / 8; q += 2) put(q, make_uint4(0, 0, 0, 0));
    return;
  }
  // x_0's pieces in flight while the branches are gathered
  const bf16* x0 = a.x[0] + ((size_t)b * a.HW + p) * a.C[0];
  for (int q = half; q < a.off[1] / 8; q += 2)
    cp_async16(smem_u32(row + (q >> 3) * kKBlock + (((q & 7) ^ (r & 7)) << 4)), x0 + q * 8, true);
  cp_async_commit();
  const int py = p / H0, px = p - py * H0;
#pragma unroll
  for (int br = 1; br < 4; ++br) {
    const int s = a.s[br], C = a.C[br];
    const float* tp = taps + (br - 1) * 4 * H0;
    const int lo = first_row(a, taps, br, p0);
    const unsigned char* tap[4];
    float m[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int dy = d >> 1, dx = d & 1;
      const int sy = (int)tp[dy * H0 + py] - lo, sx = (int)tp[dx * H0 + px];
      tap[d] = stage + a.st_off[br] + (size_t)(sy * s + sx) * C * 2;
      // the kron_interp entry: one f32 product, rounded to bf16
      m[d] = __bfloat162float(
          __float2bfloat16(__fmul_rn(tp[(2 + dy) * H0 + py], tp[(2 + dx) * H0 + px])));
    }
    for (int q = a.off[br] / 8 + half; q < (a.off[br] + C) / 8; q += 2) {
      const int cb = (q * 8 - a.off[br]) * 2;
      float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const uint4 raw = *reinterpret_cast<const uint4*>(tap[d] + cb);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          acc[2 * j] += f.x * m[d];   // a bf16 x bf16 product is exact in f32
          acc[2 * j + 1] += f.y * m[d];
        }
      }
      uint4 val;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
      put(q, val);
    }
  }
  for (int q = a.off[3] / 8 + a.C[3] / 8 + half; q < a.off[4] / 8; q += 2)
    put(q, make_uint4(0, 0, 0, 0));
  cp_async_wait(0);
}

// KG: groups of 32 joints, a template argument so that no wgmma sits in a
// branch (ptxas serialises wgmma it cannot prove warpgroup-uniform)
template <int KG>
__global__ void __launch_bounds__(kThreadsV1, 1) head_v1_kernel(const V1Args a) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the base to it
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  // the warp's index through a shuffle: ptxas then knows it is warp-uniform
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  const int b = blockIdx.y, rank = (int)cluster.block_rank();
  float* taps = reinterpret_cast<float*>(smem + a.off_taps);
  float* bh = reinterpret_cast<float*>(smem + a.off_bh);
  float* bf = reinterpret_cast<float*>(smem + a.off_bf);
  float4* part = reinterpret_cast<float4*>(smem + a.off_part);   // (warp, joint)
  float4* bpart = reinterpret_cast<float4*>(smem + a.off_bpart);
  const unsigned ring_u = smem_u32(smem + a.off_ring);
  const unsigned full_u = smem_u32(smem + a.off_full), empty_u = smem_u32(smem + a.off_empty);
  // the staging: full (the tile's rows landed), empty (both warpgroups built their feat)
  const unsigned sfull_u = smem_u32(smem + a.off_sbar), sempty_u = sfull_u + 8;
  const unsigned char* stage = smem + a.off_stage;
  constexpr int nj = KG * kJG;

  for (int i = tid; i < 12 * a.H0; i += kThreadsV1) taps[i] = a.taps[i];
  for (int i = tid; i < a.Np; i += kThreadsV1) bh[i] = a.b_head[i];
  for (int i = tid; i < nj; i += kThreadsV1) bf[i] = i < a.K ? a.b_final[i] : 0.0f;
  for (int i = tid; i < kConsumerWarps * nj; i += kThreadsV1)
    part[i] = make_float4(-INFINITY, 0.0f, 0.0f, 0.0f);
  if (tid == 0) {
    for (int st = 0; st < a.stages; ++st) {
      mbar_init(full_u + 8 * st, 1);
      mbar_init(empty_u + 8 * st, a.wgs);   // released by each consumer warpgroup
    }
    mbar_init(sfull_u, 1);
    mbar_init(sempty_u, a.wgs);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the barriers and the tables exist before any copy or wait

  const int spc = a.nkb + KG;                        // slabs per chunk
  const int nslabs = a.tiles * a.nch * spc;
  const int tile_px = 64 * a.wgs;
  if (warp == kStageWarp) {
    // -- the staging producer: per tile, the source rows of branches 1..3
    //    its taps reach, one bulk copy each, once the warpgroups have built
    //    the previous tile's feat from them
    if (lane == 0) {
      const unsigned st_u = smem_u32(stage);
      for (int t = 0; t < a.tiles; ++t) {
        if (t > 0) mbar_wait(sempty_u, (t - 1) & 1);
        const int p0 = (rank * a.tiles + t) * tile_px, npx = min(tile_px, a.HW - p0);
        unsigned bytes[4] = {0, 0, 0, 0};
        const char* src[4] = {nullptr, nullptr, nullptr, nullptr};
        if (npx > 0) {
          for (int i = 1; i < 4; ++i) {
            const int lo = first_row(a, taps, i, p0);
            const int hi = (int)taps[(i - 1) * 4 * a.H0 + a.H0 + (p0 + npx - 1) / a.H0];
            bytes[i] = min(hi - lo + 1, a.SR[i]) * a.s[i] * a.C[i] * 2;
            src[i] = reinterpret_cast<const char*>(
                a.x[i] + ((size_t)b * a.s[i] + lo) * a.s[i] * a.C[i]);
          }
        }
        mbar_expect_tx(sfull_u, bytes[1] + bytes[2] + bytes[3]);
        for (int i = 1; i < 4; ++i)
          if (bytes[i]) bulk_g2s(st_u + a.st_off[i], src[i], bytes[i], sfull_u);
      }
    }
  } else if (warp == kRingWarp) {
    // -- the ring producer: slab j of the stream into stage j % stages
    if (lane == 0) {
      RingPos rp;
      int s = 0, c = 0;   // slab s of chunk c of the stream
      for (int j = 0; j < nslabs; ++j, rp.next(a.stages)) {
        if (j >= a.stages) mbar_wait(empty_u + 8 * rp.st, rp.ph ^ 1);   // its previous use
        const unsigned bytes = s < a.nkb ? kSlab : kFinalSlab;
        const unsigned fb = full_u + 8 * rp.st, dst = ring_u + rp.st * kSlab;
        const char* src = reinterpret_cast<const char*>(a.wstream) + ((size_t)c * spc + s) * kSlab;
        if (++s == spc) {
          s = 0;
          if (++c == a.nch) c = 0;
        }
        mbar_expect_tx(fb, bytes);
        bulk_g2s(dst, src, bytes, fb);
      }
    }
  } else if (warp / 4 < a.wgs) {
    // -- a consumer warpgroup: 64 rows of each tile
    const int wg = warp / 4, wq = warp % 4, g8 = lane / 4, t4 = lane % 4;
    unsigned char* as = smem + a.off_a + wg * a.nkb * kKBlock;
    const unsigned a_u = smem_u32(as);
    const float temp = *a.temp;
    float4* wpart = part + warp * nj;
    RingPos rp;                        // the ring position of the next slab
    const int last_ksteps = (a.off[4] - (a.nkb - 1) * 64) / 16;
    // thread 0 of the warpgroup releases stage st
    auto release = [&](int st) {
      if ((tid & 127) == 0) mbar_arrive(empty_u + 8 * st);
    };
    for (int t = 0; t < a.tiles; ++t) {
      const int p0 = (rank * a.tiles + t) * tile_px, row0 = p0 + wg * 64;   // first pixels
      mbar_wait(sfull_u, t & 1);
      build_feat(a, taps, stage, b, p0, row0, as, tid & 127);
      fence_async_shared();
      bar_sync(1 + wg, 128);
      if ((tid & 127) == 0) mbar_arrive(sempty_u);   // the staging is read

      float logit[KG][16];
#pragma unroll
      for (int g = 0; g < KG; ++g)
#pragma unroll
        for (int i = 0; i < 16; ++i) logit[g][i] = 0.0f;
      for (int c = 0; c < a.nch; ++c) {
        // -- y_chunk = feat @ w_head[:, chunk]: K block kb of feat against a slab
        float acc[48];
#pragma unroll
        for (int i = 0; i < 48; ++i) acc[i] = 0.0f;
        for (int kb = 0; kb < a.nkb; ++kb, rp.next(a.stages)) {
          mbar_wait(full_u + 8 * rp.st, rp.ph);
          const int ksteps = kb + 1 < a.nkb ? 4 : last_ksteps;
          const unsigned ab = a_u + kb * kKBlock, bb = ring_u + rp.st * kSlab;
          wgmma_fence();
          for (int ks = 0; ks < ksteps; ++ks)
            wgmma_head(acc, sw128_desc(ab + ks * 32), sw128_desc(bb + ks * 32), 1);
          wgmma_commit();
          // the slab is released as soon as its products are done: the
          // other warpgroup's products keep the tensor cores busy meanwhile,
          // and the ring gains a stage of lookahead
          wgmma_wait<0>();
          release(rp.st);
        }
#pragma unroll
        for (int i = 0; i < 48; ++i) fence_reg(acc[i]);

        // -- bias, ReLU, bf16: y_chunk as the A operand of the final conv.
        //    Accumulator i of n8 tile jn is row g8 (+8 for i % 4 >= 2),
        //    columns 8 jn + 2 t4 + i % 2; k16 step kk takes n8 tiles 2kk, 2kk+1.
        unsigned yf[24];
#pragma unroll
        for (int jn = 0; jn < 12; ++jn) {
          const int col = c * kNC + jn * 8 + 2 * t4;
          const float b0 = bh[col], b1 = bh[col + 1];
          yf[2 * jn] = pack_bf16(fmaxf(acc[4 * jn] + b0, 0.0f), fmaxf(acc[4 * jn + 1] + b1, 0.0f));
          yf[2 * jn + 1] =
              pack_bf16(fmaxf(acc[4 * jn + 2] + b0, 0.0f), fmaxf(acc[4 * jn + 3] + b1, 0.0f));
        }
        // -- logits[g] += y_chunk @ w_final[chunk, group g]: the next slab, two K
        //    blocks of 32 joint rows (chunk columns 0-63, 64-95)
#pragma unroll
        for (int g = 0; g < KG; ++g, rp.next(a.stages)) {
          mbar_wait(full_u + 8 * rp.st, rp.ph);
          const unsigned fb = ring_u + rp.st * kSlab;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 6; ++kk)
            wgmma_final(logit[g], yf[4 * kk], yf[4 * kk + 1], yf[4 * kk + 2], yf[4 * kk + 3],
                        sw128_desc(fb + (kk >> 2) * (kJG * 128) + (kk & 3) * 32));
          wgmma_commit();
          wgmma_wait<0>();   // one stage at a time: a ring of 2 serves any K
          release(rp.st);
        }
      }

      // -- the tile's softmax states: per joint, the max and sums of this
      //    warp's 16 rows, merged into the warp's running state
#pragma unroll
      for (int g = 0; g < KG; ++g) {
#pragma unroll
        for (int i = 0; i < 16; ++i) fence_reg(logit[g][i]);
        const int p0 = row0 + wq * 16 + g8, p1 = p0 + 8;
        const float u0 = (float)(p0 % a.H0), v0 = (float)(p0 / a.H0);
        const float u1 = (float)(p1 % a.H0), v1 = (float)(p1 / a.H0);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = g * kJG + jn * 8 + 2 * t4 + e;
            const float l0 = p0 < a.HW ? (logit[g][4 * jn + e] + bf[k]) * temp : -INFINITY;
            const float l1 = p1 < a.HW ? (logit[g][4 * jn + 2 + e] + bf[k]) * temp : -INFINITY;
            float m = max_nan(l0, l1);
            for (int o = 4; o < 32; o *= 2) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
            const float e0 = l0 == -INFINITY ? 0.0f : expf(l0 - m);
            const float e1 = l1 == -INFINITY ? 0.0f : expf(l1 - m);
            float s = e0 + e1, su = e0 * u0 + e1 * u1, sv = e0 * v0 + e1 * v1;
            for (int o = 4; o < 32; o *= 2) {
              s += __shfl_xor_sync(0xffffffffu, s, o);
              su += __shfl_xor_sync(0xffffffffu, su, o);
              sv += __shfl_xor_sync(0xffffffffu, sv, o);
            }
            if (g8 == 0) merge_softmax(wpart[k], m, s, su, sv);
          }
        }
      }
    }
  }

  // -- the block's state per joint, then the cluster's through distributed
  //    shared memory; rank 0 divides once
  __syncthreads();
  for (int k = tid; k < a.K; k += kThreadsV1) {
    float4 P = make_float4(-INFINITY, 0.0f, 0.0f, 0.0f);
    for (int w = 0; w < kConsumerWarps; ++w) {
      const float4 q = part[w * nj + k];
      merge_softmax(P, q.x, q.y, q.z, q.w);
    }
    bpart[k] = P;
  }
  cluster.sync();
  if (rank == 0) {
    for (int k = tid; k < a.K; k += kThreadsV1) {
      float4 P = make_float4(-INFINITY, 0.0f, 0.0f, 0.0f);
      for (int r = 0; r < a.cluster; ++r) {
        const float4 q = cluster.map_shared_rank(bpart, r)[k];
        merge_softmax(P, q.x, q.y, q.z, q.w);
      }
      a.out[((size_t)b * a.K + k) * 2 + 0] = P.z / P.y;
      a.out[((size_t)b * a.K + k) * 2 + 1] = P.w / P.y;
    }
  }
  cluster.sync();   // no block leaves while rank 0 reads its shared memory
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// v1 of the head in one launch with the plan of fused_head_decode.py::
// head_v1_plan: `cluster` blocks per sample (a thread-block cluster), each
// walking `tiles` tiles of 64 * wgs pixels, a ring of `stages` slabs, at
// most SR_i source rows of branch i staged per tile, `smem` bytes.
// Branches bf16 NHWC on square maps, C_i % 8 == 0 (the wrapper pads),
// 16-byte aligned; feat columns off_i = C_0 + .. + C_{i-1}, ctot >= their
// sum a multiple of 16; wstream as fused_head_decode.py::v1_weight_stream
// lays it out for Np (a multiple of 96) and K; taps (3, 4, H0) f32.  A plan whose numbers do not add up
// returns cudaErrorInvalidValue; else the launch's error.
extern "C" int hrnet_head_v1(const void* x0, const void* x1, const void* x2, const void* x3,
                             const void* wstream, const void* b_head, const void* b_final,
                             const void* temp, const void* taps, void* out, int B, int H0, int s1,
                             int s2, int s3, int C0, int C1, int C2, int C3, int ctot, int Np,
                             int K, int wgs, int cluster, int tiles, int stages, int SR1,
                             int SR2, int SR3, int smem, void* stream) {
  V1Args a{};
  const void* xs[4] = {x0, x1, x2, x3};
  const int ss[4] = {H0, s1, s2, s3}, cs[4] = {C0, C1, C2, C3}, srs[4] = {0, SR1, SR2, SR3};
  bool ok = B >= 1 && B <= 65535 && H0 >= 1 && K >= 1 && K <= kMaxKG * kJG && Np >= kNC &&
            Np % kNC == 0 && (wgs == 1 || wgs == 2) && cluster >= 1 && cluster <= kMaxCluster &&
            (cluster & (cluster - 1)) == 0 && tiles >= 1 && stages >= 2 && stages <= 8 &&
            ctot % 16 == 0 && (long long)cluster * tiles * wgs * 64 >= (long long)H0 * H0;
  a.off[0] = 0;
  for (int i = 0; i < 4; ++i) {
    a.x[i] = static_cast<const bf16*>(xs[i]);
    a.s[i] = ss[i];
    a.C[i] = cs[i];
    a.SR[i] = srs[i];
    a.off[i + 1] = a.off[i] + cs[i];
    ok = ok && ss[i] >= 1 && cs[i] >= 8 && cs[i] % 8 == 0 &&
         reinterpret_cast<uintptr_t>(xs[i]) % 16 == 0 &&
         (i == 0 || (srs[i] >= 1 && srs[i] <= ss[i]));
  }
  ok = ok && ctot >= a.off[4] && ctot - a.off[4] < 16;
  if (!ok) return (int)cudaErrorInvalidValue;
  a.off[4] = ctot;
  a.wstream = static_cast<const bf16*>(wstream);
  a.b_head = static_cast<const float*>(b_head);
  a.b_final = static_cast<const float*>(b_final);
  a.temp = static_cast<const float*>(temp);
  a.taps = static_cast<const float*>(taps);
  a.out = static_cast<float*>(out);
  a.H0 = H0;
  a.HW = H0 * H0;
  a.Np = Np;
  a.K = K;
  a.KG = (K + kJG - 1) / kJG;
  a.nkb = (ctot + 63) / 64;
  a.nch = Np / kNC;
  a.wgs = wgs;
  a.tiles = tiles;
  a.cluster = cluster;
  a.stages = stages;
  v1_layout(a);
  if (a.smem != smem || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  static int raised[kMaxKG][kMaxDevices] = {};
  switch (a.KG) {
    case 1: err = raise_smem(head_v1_kernel<1>, smem, raised[0]); break;
    case 2: err = raise_smem(head_v1_kernel<2>, smem, raised[1]); break;
    case 3: err = raise_smem(head_v1_kernel<3>, smem, raised[2]); break;
    default: err = raise_smem(head_v1_kernel<4>, smem, raised[3]); break;
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);
  cfg.blockDim = dim3(kThreadsV1, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  switch (a.KG) {
    case 1: err = cudaLaunchKernelEx(&cfg, head_v1_kernel<1>, a); break;
    case 2: err = cudaLaunchKernelEx(&cfg, head_v1_kernel<2>, a); break;
    case 3: err = cudaLaunchKernelEx(&cfg, head_v1_kernel<3>, a); break;
    default: err = cudaLaunchKernelEx(&cfg, head_v1_kernel<4>, a); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The v1 kernel's registers, local (spill) bytes and static shared bytes
// per thread block as compiled for `joint_groups` groups of 32 joints, for
// reports: out[0..2].
extern "C" int hrnet_head_v1_attributes(int joint_groups, void* out) {
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, joint_groups == 1   ? head_v1_kernel<1>
             : joint_groups == 2 ? head_v1_kernel<2>
             : joint_groups == 3 ? head_v1_kernel<3>
                                 : head_v1_kernel<4>);
  int* o = static_cast<int*>(out);
  o[0] = attr.numRegs;
  o[1] = (int)attr.localSizeBytes;
  o[2] = (int)attr.sharedSizeBytes;
  return (int)err;
}
