// Shared helpers of the port's CUDA kernels (built for sm_90a by nvcc with a
// plain C interface; see ops/kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace hrnet {

typedef __nv_bfloat16 bf16;
namespace wmma = nvcuda::wmma;

// 16x16x16 bf16 tensor-core tiles with f32 accumulation (mma.sync under the
// hood).  Every pointer handed to load/store_matrix_sync is 32-byte aligned
// and every leading dimension a multiple of 16 elements (bf16) or 8 (f32).
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// extra elements per shared-memory row: keeps rows 32-byte aligned and
// staggers them across banks
constexpr int kRowPad = 16;

// ---- int8 tensor cores: mma.sync.m16n8k32 s8 x s8 -> s32 (sm_80 and later).
// Fragments are loaded by hand from int8 rows in shared memory whose stride
// and column offsets are multiples of 4 bytes (WMMA's int8 tiles would need
// 32-byte aligned tile starts, which a 3x3 tap's shifted rows do not give).
// Layouts (PTX ISA, mma.m16n8k32 .s8), g = lane / 4, t = lane % 4:
//   A 16x32 row-major: a0 = A[g][4t..4t+3], a1 = A[g+8][4t..], a2 = A[g][16+4t..],
//                      a3 = A[g+8][16+4t..]
//   B 32x8, read from B^T (n rows, k contiguous): b0 = Bt[g][4t..], b1 = Bt[g][16+4t..]
//   C 16x8: c0, c1 = C[g][2t, 2t+1]; c2, c3 = C[g+8][2t, 2t+1]
__device__ inline void load_a_s8(unsigned (&a)[4], const signed char* base, int ld, int lane) {
  const signed char* p0 = base + (lane >> 2) * ld + (lane & 3) * 4;
  const signed char* p1 = p0 + 8 * ld;
  a[0] = *reinterpret_cast<const unsigned*>(p0);
  a[1] = *reinterpret_cast<const unsigned*>(p1);
  a[2] = *reinterpret_cast<const unsigned*>(p0 + 16);
  a[3] = *reinterpret_cast<const unsigned*>(p1 + 16);
}

__device__ inline void load_b_s8(unsigned (&b)[2], const signed char* bt, int ld, int lane) {
  const signed char* p = bt + (lane >> 2) * ld + (lane & 3) * 4;
  b[0] = *reinterpret_cast<const unsigned*>(p);
  b[1] = *reinterpret_cast<const unsigned*>(p + 16);
}

__device__ inline void mma_s8(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The W8A8 scheme's roundings, as the JAX package takes them.  rintf rounds
// half to even like jnp.round (roundf would round half away from zero); the
// clip is to +-127, never -128; products and sums are written as __fmul_rn /
// __fadd_rn so that nvcc cannot contract them into one FMA (JAX rounds the
// product, then the sum).
__device__ inline signed char clip_s8(float v) {
  return (signed char)fminf(fmaxf(rintf(v), -127.0f), 127.0f);
}

// clip(round(relu(acc * a + c))): the requant epilogue inside the layer1 chain
__device__ inline signed char requant_s8(int acc, float a, float c) {
  return clip_s8(fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), a), c), 0.0f));
}

// eight int8 values, first in the lowest byte, for one 8-byte store
__device__ inline uint2 pack8(const signed char (&q)[8]) {
  unsigned w[2];
  for (int h = 0; h < 2; ++h)
    w[h] = (unsigned)(unsigned char)q[4 * h] | ((unsigned)(unsigned char)q[4 * h + 1] << 8) |
           ((unsigned)(unsigned char)q[4 * h + 2] << 16) |
           ((unsigned)(unsigned char)q[4 * h + 3] << 24);
  return make_uint2(w[0], w[1]);
}

// acc * a + c in f32, rounded twice: the dequant epilogue
__device__ inline float dequant(int acc, float a, float c) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), a), c);
}

}  // namespace hrnet
