// The implicit-GEMM convolution mainloop shared by the bf16 kernels
// (basic_chain.cu, fused_bottleneck.cu, stem_layer1.cu) and the W8A8 ones
// (conv_int8.cu, int8_chain.cu, basic_int8.cu).
//
// M is the output pixels of a block's tile, N its output channels, and K walks
// (tap, input-channel slab).  Both kernels
// - stage the input halo of their tile once in shared memory, each pixel a
//   row whose stride is an odd multiple of 16 bytes, so that the 8 rows of an
//   ldmatrix phase (8 neighbouring pixels) fall on 8 different bank groups;
// - read A by ldmatrix.x4 with per-lane row addresses: each lane points at
//   its own pixel's halo row for the current tap, so a 3x3 tap is an address
//   offset and no pixel outside the tile is computed;
// - stream B, the weights, through a ring of `stages` slabs in shared memory
//   with 16-byte cp.async copies (one commit group per slab): while slab j is
//   multiplied, slabs j+1 .. j+stages-1 are in flight, and no weight is read
//   from global memory inside the MMA loop;
// - multiply on the tensor cores with mma.sync (m16n8k16 bf16 here, m16n8k32
//   s8 in common.cuh; f32 / s32 sums) and run their epilogue from the
//   accumulator registers.
#pragma once

#include "common.cuh"

namespace hrnet {

// the most dynamic shared memory one block may take on an H100
constexpr int kSmemLimit = 232448;
constexpr int kMaxDevices = 64;

// Let `kernel` take `smem` bytes of dynamic shared memory on the current
// device.  The attribute is per device; `raised` is the caller's record of
// the largest size set on each, so the call costs one cudaGetDevice after
// the first launch of a size.
template <class Kernel>
__host__ inline cudaError_t raise_smem(Kernel* kernel, int smem, int (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = smem;
  return err;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Bulk copies (the Tensor Memory Accelerator's 1D form) that complete on an
// mbarrier, for the heads' weight rings (fused_head_decode.cu, head_v1.cu).
// Measured on the H100 (PERF.md), a w32 block of the head with every MMA
// removed spent 76K cycles of a pass on a ring of 16-byte cp.async copies and
// 62K on bulk copies.
__device__ __forceinline__ void mbar_init(unsigned addr, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned addr, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(addr), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned addr, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, completing on mbar
__device__ __forceinline__ void bulk_g2s(unsigned dst, const void* src, unsigned bytes,
                                         unsigned mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

// two floats as one bf16x2 word, low half first
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// 16-byte asynchronous copy global -> shared; `valid == false` writes 16 zero
// bytes and reads nothing (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n commit groups are still in flight (n > 6 waits as 6)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// four 8x8 b16 matrices; lane l gives the row address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b, m16n8k16, bf16 operands, f32 sums.  A row-major 16x16 (the four
// registers of ldsm_x4 at row lane % 16, column (lane / 16) * 8), B 16x8
// "col" (b[0]: k 0-7, b[1]: k 8-15 of column lane / 4).  The int8 kernels'
// m16n8k32 counterpart is common.cuh's mma_s8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The weight ring.  A stream of J slabs, slab j in stage j % stages of
// `ring` (stage_bytes apart).  load(j, stage) issues slab j's cp.async copies
// from all threads of the block; compute(j, stage) consumes slab j.
template <class Load>
__device__ __forceinline__ void ring_prologue(unsigned char* ring, int stage_bytes, int stages,
                                              int J, Load load) {
  for (int j = 0; j < stages - 1; ++j) {
    if (j < J) load(j, ring + j * stage_bytes);
    cp_async_commit();
  }
}

// Slabs [j0, j1) of the stream.  One barrier per slab: after it every warp
// is done with slab j - 1, whose stage then takes slab j + stages - 1.
// Every iteration commits one group (empty past the end), so that
// wait(stages - 2) always means "slab j has landed".
template <class Load, class Compute>
__device__ __forceinline__ void ring_run(unsigned char* ring, int stage_bytes, int stages, int J,
                                         int j0, int j1, Load load, Compute compute) {
  for (int j = j0; j < j1; ++j) {
    cp_async_wait(stages - 2);
    __syncthreads();
    const int jn = j + stages - 1;
    if (jn < J) load(jn, ring + (jn % stages) * stage_bytes);
    cp_async_commit();
    compute(j, ring + (j % stages) * stage_bytes);
  }
}

// ---- the int8 operands (int8_chain.cu, basic_int8.cu; conv_int8.cu keeps
// its own copy of the same loop).  Activations are int8 pixel rows in
// shared memory, `ld` bytes apart (an odd multiple of 16); weights are
// N-major slabs in the ring, one row of KB bytes of K per output channel,
// `rowb` = KB + 16 bytes apart.  ldmatrix moves 16-bit elements, so .trans
// cannot transpose int8: B has to arrive N-major, and ldmatrix without .trans
// then gives mma.m16n8k32's B fragments directly.
//
// This lane's ldmatrix address (bytes into a stage) of the B fragments of
// channels n0 ..: matrix q = lane / 8 holds channels n0 + (q / 2) * 8 + lane
// % 8, K bytes (q % 2) * 16 .. (b0 and b1 of two n8 tiles per ldsm_x4).
__device__ __forceinline__ unsigned b_lane_s8(int n0, int rowb, int lane) {
  return (n0 + ((lane >> 4) << 3) + (lane & 7)) * rowb + ((lane >> 3) & 1) * 16;
}

// This lane's ldmatrix address of the A rows of pixel row `row` (int8, `ld`
// bytes per row): lanes 0-15 the row's first 16 bytes of a k32 step, lanes
// 16-31 the next 16 (a0..a3 of mma.m16n8k32 by one ldsm_x4).
__device__ __forceinline__ unsigned a_lane_s8(const signed char* rows, int row, int ld,
                                              int lane) {
  return smem_u32(rows + row * ld + (lane >> 4) * 16);
}

// acc += A (MT m16 tiles, row addresses a[i] + a_off) x one ring slab of KB
// bytes of K (sb: this lane's b_lane_s8 address in the stage, rows rowb
// bytes apart), int8 x int8 -> int32 by mma.sync m16n8k32; m16 tiles with
// ok[i] false are skipped (warp-uniform).  NT is even.
template <int MT, int NT>
__device__ __forceinline__ void slab_mma_s8(int (&acc)[MT][NT][4], const unsigned (&a)[MT],
                                            const bool (&ok)[MT], unsigned a_off, unsigned sb,
                                            int rowb, int KB) {
  for (int kk = 0; kk < KB; kk += 32) {
    // every fragment load of the k32 step first, then the MMAs
    unsigned b[NT][2], fa[MT][4];
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      unsigned r[4];
      ldsm_x4(r, sb + jp * 16 * rowb + kk);
      b[2 * jp][0] = r[0];
      b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2];
      b[2 * jp + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (ok[i]) ldsm_x4(fa[i], a[i] + a_off + kk);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (!ok[i]) continue;
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) mma_s8(acc[i][jn], fa[i], b[jn]);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_s32(int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0;
}

// two int8 values at an even byte offset, as one 16-bit store
__device__ __forceinline__ void store_s8x2(signed char* dst, signed char q0, signed char q1) {
  *reinterpret_cast<unsigned short*>(dst) =
      (unsigned short)((unsigned)(unsigned char)q0 | ((unsigned)(unsigned char)q1 << 8));
}

// Quantize a window of bf16 pixels into int8 rows in shared memory:
// dst[p * ld + c] = clip(round(x * inv)) for window pixel p = (hy, hx) of an
// RW-wide window whose pixel (0, 0) is image pixel (gy0, gx0); 0 outside the
// image.  C % 8 == 0 and C <= 8 * kThreads: each thread takes one 8-channel
// column and steps pixels, with up to 4 16-byte loads in flight before it
// quantizes any.  The block input is MULTIPLIED by inv (the chains' rule;
// conv_int8.cu divides).
__device__ __forceinline__ void quantize_window(signed char* dst, int ld, const bf16* x, int H,
                                                int W, int C, int gy0, int gx0, int RW, int npx,
                                                float inv) {
  constexpr int kBatch = 4;
  const int vpr = C / 8, pstep = kThreads / vpr;
  const int v = threadIdx.x % vpr, p0 = threadIdx.x / vpr;   // p0 >= pstep: idle
  if (p0 >= pstep) return;
  const bf16* xb = x + v * 8;
  int hy = p0 / RW, hx = p0 - hy * RW;
  for (int pix0 = p0; pix0 < npx; pix0 += kBatch * pstep) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int gy = gy0 + hy, gx = gx0 + hx;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (pix0 + u * pstep < npx && gy >= 0 && gy < H && gx >= 0 && gx < W)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)gy * W + gx) * C));
      for (hx += pstep; hx >= RW; hx -= RW) ++hy;
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
        q[2 * e] = clip_s8(__fmul_rn(f.x, inv));
        q[2 * e + 1] = clip_s8(__fmul_rn(f.y, inv));
      }
      *reinterpret_cast<uint2*>(dst + pix * ld + v * 8) = pack8(q);
    }
  }
}

// bytes per shared-memory row of n int8 values (n % 16 == 0): n + 16 or
// n + 32, an odd multiple of 16 (the 8 rows of an ldmatrix phase on 8 bank
// groups) with at least 16 bytes past n (a k32 step of a 16-channel tail
// reads them; its B half there is 0)
__host__ __device__ inline int pitch_s8(int n) { return n + (n % 32 == 0 ? 16 : 32); }

}  // namespace hrnet
