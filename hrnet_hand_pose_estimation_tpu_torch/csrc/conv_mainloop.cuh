// The implicit-GEMM convolution mainloop shared by the bf16 BasicBlock kernel
// (basic_chain.cu) and the W8A8 site conv (conv_int8.cu).
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

}  // namespace hrnet
