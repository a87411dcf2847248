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

}  // namespace hrnet
