// HRNet's head + spatial softmax + soft-argmax, as three launches.
//
// Replaces the TPU kernel ops/pallas/fused_head_decode.py::fused_head_decode_v2
// (body _kernel_v2).  The head's 1x1 conv (480 -> 480, BN folded) distributes
// over the channel concat and commutes with the align-corners bilinear
// upsample, so each branch is convolved at its native resolution with its
// row slice of the folded kernel and the results are upsampled and summed:
//   (a) branch_conv_kernel: y_i = bf16(x_i @ W_i) for branches 1..3, at native
//       resolution, into a workspace (bf16, where the TPU kernel rounds too);
//   (b) head_logits_tiles_kernel or head_logits_kernel (any): per
//       full-resolution pixel, the bilinear samples of
//       y_1..y_3 (W-mix weights rounded to bf16 and f32 H-mix taps, as in the
//       TPU kernel) + b_head, plus x_0 @ W_0, ReLU, rounded to bf16, then the
//       final 1x1 conv to K joints, + b_final, x temperature -> logits
//       (B, K, H*W) f32 in a workspace;
//   (c) softmax_decode_kernel: one block per (sample, joint): max, exp, sum and
//       the expectation of the column (u) and row (v) -> (B, K, 2) f32.
// K is never padded in memory: (b) stages the final conv's weights in shared
// memory 32 columns at a time (zero past K, up to K = 128) and writes only
// the K real columns; nothing downstream reads the pad.
//
// Widths: any branch width C_i, head width N, K <= 128 and any B*h*w.  The
// wrapper pads the weights (once per call, with the slices it makes anyway)
// to Cp_i = C_i and Np = N rounded up to 16 with zero rows and columns; (a)
// and the any-width (b) stage the branch inputs into those pitches with zeros
// past C_i (16-byte vectors where C_i % 8 == 0, else element by element) and
// mask the rows past B*h*w.  Zero channels add exact zeros, and a padded
// head channel stays relu(0) = 0, so the function is unchanged.  Heads with
// C_0 % 16 == 0 and K <= 32 (every w32 and w48 one) run (b) as the
// fixed-width head_logits_tiles_kernel, compiled apart: with the tails folded
// in, (b) was given 44 registers instead of 60 and took 0.5 ms more at B=128
// (H100 80GB HBM3, 700 W, torch.profiler).
//
// What bounds it on the H100: ~0.37 GFLOP per sample against ~0.5 MB of
// branch tensors in and 168 bytes out, ~700 FLOP per byte: tensor-core
// throughput bounds the function.  As written it also moves its workspaces
// through device memory (y_1..y_3 ~1.3 MB and the logits ~0.34 MB per
// sample), and (b) gathers 12 bf16 samples per output element from L1/L2,
// so memory traffic, not the tensor cores, is what this first version pays;
// fusing (b) and (c) and a separable upsample in shared memory are later work.
//
// int8-input mode (the int8 serving path's HEAD_SCALES_KEY, the TPU kernel's
// input_scales): the four branches arrive as int8 (B, h, w, C_i) with
// x_i ~= sa_i * xq_i; the wrapper folds sa_i into W_i in f32 before the bf16
// cast, and (a) and (b) cast the int8 values to bf16 on load, which is exact
// for |v| <= 127.  The branch tensors are then half the bytes.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace hrnet {
namespace {

constexpr int kRows = 64;   // rows of x per block in (a), output pixels per block in (b)
constexpr int kKPad = 32;   // final-conv columns held in shared memory at a time

// channels c .. c + 7 of row `row` (C channels, type T) as 8 bf16, 0 past C:
// one 16-byte (bf16) or 8-byte (int8) load where C % 8 == 0, else element by
// element; int8 values convert exactly
template <typename T>
__device__ inline uint4 load8_bf16(const T* row, int c, int C) {
  uint4 val = make_uint4(0, 0, 0, 0);
  if (c >= C) return val;
  if constexpr (std::is_same<T, bf16>::value) {
    if (C % 8 == 0) return *reinterpret_cast<const uint4*>(row + c);
  }
  bf16* h = reinterpret_cast<bf16*>(&val);
  if constexpr (std::is_same<T, bf16>::value) {
    for (int e = 0; e < 8; ++e) h[e] = c + e < C ? row[c + e] : __float2bfloat16(0.0f);
  } else if (C % 8 == 0) {
    const uint2 q = *reinterpret_cast<const uint2*>(row + c);
    const signed char* b = reinterpret_cast<const signed char*>(&q);
    for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16((float)b[e]);
  } else {
    for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16(c + e < C ? (float)row[c + e] : 0.0f);
  }
  return val;
}

struct BranchConvArgs {
  const void* x[3];       // (M_i, C_i) = branch i+1 flattened NHWC, bf16 or int8
  const bf16* w[3];       // (Cp_i, N): C_i rows rounded up to 16, zero past C_i
  bf16* y[3];             // (M_i, N)
  int M[3], C[3];
  int first_block[4];     // prefix sums of the row blocks of each branch
  int N;                  // a multiple of 16
};

// (a)'s shared memory: the block's 64 rows at the widest branch's pitch, and
// the warps' f32 scratch tiles
__host__ inline size_t branch_smem_bytes(int cmax) {
  return (size_t)kRows * ((cmax + 15) / 16 * 16 + kRowPad) * sizeof(bf16) +
         (size_t)kWarps * 256 * sizeof(float);
}

// One block = 64 rows of one branch x every output column: the rows are
// staged once (zero past C and past M), then each warp walks its 16 rows
// across every other 16-column tile, B fragments from global memory.
template <typename T>
__global__ void __launch_bounds__(kThreads) branch_conv_kernel(BranchConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int br = blockIdx.x >= a.first_block[2] ? 2 : (blockIdx.x >= a.first_block[1] ? 1 : 0);
  const int mb = (blockIdx.x - a.first_block[br]) * kRows, mw = (warp % 4) * 16;
  const int M = a.M[br], C = a.C[br], N = a.N;
  const int cp = (C + 15) / 16 * 16, ldx = cp + kRowPad;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* scratch = reinterpret_cast<float*>(xs + kRows * ldx) + warp * 256;
  const T* x = static_cast<const T*>(a.x[br]);
  const int vpr = cp / 8;
  for (int i = threadIdx.x; i < kRows * vpr; i += kThreads) {
    const int r = i / vpr, v = i - r * vpr;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (mb + r < M) val = load8_bf16(x + (size_t)(mb + r) * C, v * 8, C);
    *reinterpret_cast<uint4*>(xs + r * ldx + v * 8) = val;
  }
  __syncthreads();
  if (mb + mw >= M) return;   // warp-uniform: no rows of this warp
  const bf16* w = a.w[br];
  bf16* y = a.y[br];
  FragA fa;
  FragB fb;
  FragC acc;
  for (int n0 = (warp / 4) * 16; n0 < N; n0 += 32) {
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < cp; k += 16) {
      wmma::load_matrix_sync(fa, xs + mw * ldx + k, ldx);
      wmma::load_matrix_sync(fb, w + (size_t)k * N + n0, N);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      if (mb + mw + e / 16 < M)
        y[(size_t)(mb + mw + e / 16) * N + n0 + e % 16] = __float2bfloat16(scratch[e]);
    __syncwarp();
  }
}

struct LogitsArgs {
  const void* x0;        // (B, H0*W0, C0), bf16 or int8
  const bf16* w0;        // (Cp0, N): C0 rows rounded up to 16, zero past C0
  const bf16* y[3];      // (B, h_i*w_i, N)
  const float* taps;     // (3 branches, 2 axes, 3 fields {lo, a, b}, L)
  const float* b_head;   // (N), N a multiple of 16 (zero past the head's width)
  const bf16* w_final;   // (N, K)
  const float* b_final;  // (K)
  const float* temp;     // ()
  float* logits;         // (B, K, H0*W0)
  int H0, W0, C0;
  int h[3], w[3];
  int N, K, L;
};

__host__ __device__ inline size_t logits_smem_bytes(int c0, int n) {
  const int cp0 = (c0 + 15) / 16 * 16;
  return (size_t)(kRows * (cp0 + kRowPad) + kRows * (n + kRowPad) + n * kKPad) * sizeof(bf16) +
         (size_t)kWarps * 256 * sizeof(float);
}

// C0 % 16 == 0 and K <= 32 (every w32 and w48 head): x0 by 16-byte vectors,
// the final conv in one pass
template <typename T>
__global__ void __launch_bounds__(kThreads) head_logits_tiles_kernel(LogitsArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = a.C0 + kRowPad, ldh = a.N + kRowPad;
  bf16* xs = reinterpret_cast<bf16*>(smem);   // kRows x ldx
  bf16* hs = xs + kRows * ldx;                // kRows x ldh: relu(head) in bf16
  bf16* wf = hs + kRows * ldh;                // N x kKPad: final conv, zero pad columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(wf + a.N * kKPad) + warp * 256;

  const int HW = a.H0 * a.W0, b = blockIdx.y, p0 = blockIdx.x * kRows;
  const int vec_per_row = a.C0 / 8;
  for (int i = threadIdx.x; i < kRows * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row, v = i % vec_per_row;
    uint4 val = make_uint4(0, 0, 0, 0);
    const size_t off = ((size_t)b * HW + p0 + r) * a.C0 + v * 8;
    if (p0 + r < HW) {
      if constexpr (std::is_same<T, bf16>::value) {
        val = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.x0) + off);
      } else {   // 8 int8 values -> 8 bf16, exact
        const signed char* q = static_cast<const signed char*>(a.x0) + off;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
        for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn((float)q[2 * j], (float)q[2 * j + 1]);
      }
    }
    *reinterpret_cast<uint4*>(xs + r * ldx + v * 8) = val;
  }
  for (int i = threadIdx.x; i < a.N * kKPad; i += kThreads) {
    const int r = i / kKPad, c = i % kKPad;
    wf[i] = c < a.K ? a.w_final[r * a.K + c] : __float2bfloat16(0.0f);
  }
  __syncthreads();

  FragA fa;
  FragB fb;
  FragC acc;
  const int ntn = a.N / 16;
  for (int task = warp; task < (kRows / 16) * ntn; task += kWarps) {
    const int mt = task / ntn, nt = task % ntn;
    // bias + the bilinear samples of branches 1..3 seed the accumulator
    for (int e = lane; e < 256; e += 32) {
      const int p = p0 + mt * 16 + e / 16, n = nt * 16 + e % 16;
      float v = a.b_head[n];
      if (p < HW) {
        const int py = p / a.W0, px = p % a.W0;
        for (int i = 0; i < 3; ++i) {
          const float* tr = a.taps + (size_t)(i * 2 + 0) * 3 * a.L;
          const float* tc = a.taps + (size_t)(i * 2 + 1) * 3 * a.L;
          const int r0 = (int)tr[py], c0 = (int)tc[px];
          const float ra = tr[a.L + py], rb = tr[2 * a.L + py];
          const float ca = tc[a.L + px], cb = tc[2 * a.L + px];
          const int wi = a.w[i];
          const bf16* yb = a.y[i] + ((size_t)b * a.h[i] * wi + (size_t)r0 * wi + c0) * a.N + n;
          const float t0 = ca * __bfloat162float(yb[0]) + cb * __bfloat162float(yb[a.N]);
          const float t1 = ca * __bfloat162float(yb[(size_t)wi * a.N]) +
                           cb * __bfloat162float(yb[(size_t)(wi + 1) * a.N]);
          v += ra * t0 + rb * t1;
        }
      }
      scratch[e] = v;
    }
    __syncwarp();
    wmma::load_matrix_sync(acc, scratch, 16, wmma::mem_row_major);
    for (int k = 0; k < a.C0; k += 16) {
      wmma::load_matrix_sync(fa, xs + mt * 16 * ldx + k, ldx);
      wmma::load_matrix_sync(fb, a.w0 + (size_t)k * a.N + nt * 16, a.N);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      hs[(mt * 16 + e / 16) * ldh + nt * 16 + e % 16] = __float2bfloat16(fmaxf(scratch[e], 0.0f));
    __syncwarp();
  }
  __syncthreads();

  // final 1x1 conv: (kRows x N) @ (N x kKPad), one 16x16 tile per warp
  const int mt = warp / 2, nt = warp % 2;
  wmma::fill_fragment(acc, 0.0f);
  for (int k = 0; k < a.N; k += 16) {
    wmma::load_matrix_sync(fa, hs + mt * 16 * ldh + k, ldh);
    wmma::load_matrix_sync(fb, wf + k * kKPad + nt * 16, kKPad);
    wmma::mma_sync(acc, fa, fb, acc);
  }
  wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const float temp = *a.temp;
  for (int e = lane; e < 256; e += 32) {
    const int c = e / 16, r = e % 16;   // consecutive lanes: consecutive pixels
    const int kk = nt * 16 + c, p = p0 + mt * 16 + r;
    if (kk < a.K && p < HW)
      a.logits[((size_t)b * a.K + kk) * HW + p] = (scratch[r * 16 + c] + a.b_final[kk]) * temp;
  }
}

// Any C0 and K <= 128: x0 staged with zeros past C0, the final conv kKPad
// joints at a time
template <typename T>
__global__ void __launch_bounds__(kThreads) head_logits_kernel(LogitsArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cp0 = (a.C0 + 15) / 16 * 16;
  const int ldx = cp0 + kRowPad, ldh = a.N + kRowPad;
  bf16* xs = reinterpret_cast<bf16*>(smem);   // kRows x ldx
  bf16* hs = xs + kRows * ldx;                // kRows x ldh: relu(head) in bf16
  bf16* wf = hs + kRows * ldh;                // N x kKPad: final conv, zero pad columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(wf + a.N * kKPad) + warp * 256;

  const int HW = a.H0 * a.W0, b = blockIdx.y, p0 = blockIdx.x * kRows;
  const int vec_per_row = cp0 / 8;
  for (int i = threadIdx.x; i < kRows * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row, v = i % vec_per_row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (p0 + r < HW)
      val = load8_bf16(static_cast<const T*>(a.x0) + ((size_t)b * HW + p0 + r) * a.C0, v * 8, a.C0);
    *reinterpret_cast<uint4*>(xs + r * ldx + v * 8) = val;
  }
  // the final conv's first kKPad columns, zero past K
  for (int i = threadIdx.x; i < a.N * kKPad; i += kThreads) {
    const int r = i / kKPad, c = i % kKPad;
    wf[i] = c < a.K ? a.w_final[r * a.K + c] : __float2bfloat16(0.0f);
  }
  __syncthreads();

  FragA fa;
  FragB fb;
  FragC acc;
  const int ntn = a.N / 16;
  for (int task = warp; task < (kRows / 16) * ntn; task += kWarps) {
    const int mt = task / ntn, nt = task % ntn;
    // bias + the bilinear samples of branches 1..3 seed the accumulator
    for (int e = lane; e < 256; e += 32) {
      const int p = p0 + mt * 16 + e / 16, n = nt * 16 + e % 16;
      float v = a.b_head[n];
      if (p < HW) {
        const int py = p / a.W0, px = p % a.W0;
        for (int i = 0; i < 3; ++i) {
          const float* tr = a.taps + (size_t)(i * 2 + 0) * 3 * a.L;
          const float* tc = a.taps + (size_t)(i * 2 + 1) * 3 * a.L;
          const int r0 = (int)tr[py], c0 = (int)tc[px];
          const float ra = tr[a.L + py], rb = tr[2 * a.L + py];
          const float ca = tc[a.L + px], cb = tc[2 * a.L + px];
          const int wi = a.w[i];
          const bf16* yb = a.y[i] + ((size_t)b * a.h[i] * wi + (size_t)r0 * wi + c0) * a.N + n;
          const float t0 = ca * __bfloat162float(yb[0]) + cb * __bfloat162float(yb[a.N]);
          const float t1 = ca * __bfloat162float(yb[(size_t)wi * a.N]) +
                           cb * __bfloat162float(yb[(size_t)(wi + 1) * a.N]);
          v += ra * t0 + rb * t1;
        }
      }
      scratch[e] = v;
    }
    __syncwarp();
    wmma::load_matrix_sync(acc, scratch, 16, wmma::mem_row_major);
    for (int k = 0; k < cp0; k += 16) {
      wmma::load_matrix_sync(fa, xs + mt * 16 * ldx + k, ldx);
      wmma::load_matrix_sync(fb, a.w0 + (size_t)k * a.N + nt * 16, a.N);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      hs[(mt * 16 + e / 16) * ldh + nt * 16 + e % 16] = __float2bfloat16(fmaxf(scratch[e], 0.0f));
    __syncwarp();
  }
  __syncthreads();

  // final 1x1 conv, kKPad joints at a time: (kRows x N) @ (N x kKPad), one
  // 16x16 tile per warp
  const int mt = warp / 2, nt = warp % 2;
  const float temp = *a.temp;
  for (int kc = 0; kc < a.K; kc += kKPad) {
    if (kc) {   // the next columns, once every warp is done with the previous ones
      __syncthreads();
      for (int i = threadIdx.x; i < a.N * kKPad; i += kThreads) {
        const int r = i / kKPad, c = i % kKPad;
        wf[i] = kc + c < a.K ? a.w_final[r * a.K + kc + c] : __float2bfloat16(0.0f);
      }
      __syncthreads();
    }
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < a.N; k += 16) {
      wmma::load_matrix_sync(fa, hs + mt * 16 * ldh + k, ldh);
      wmma::load_matrix_sync(fb, wf + k * kKPad + nt * 16, kKPad);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int c = e / 16, r = e % 16;   // consecutive lanes: consecutive pixels
      const int kk = kc + nt * 16 + c, p = p0 + mt * 16 + r;
      if (kk < a.K && p < HW)
        a.logits[((size_t)b * a.K + kk) * HW + p] = (scratch[r * 16 + c] + a.b_final[kk]) * temp;
    }
    __syncwarp();
  }
}

__device__ inline float block_reduce(float v, bool is_max, float* red) {
  for (int off = 16; off > 0; off /= 2) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();   // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < kWarps; ++i) v = is_max ? fmaxf(v, red[i]) : v + red[i];
  return v;
}

__global__ void __launch_bounds__(kThreads) softmax_decode_kernel(const float* logits, float* out,
                                                                  int K, int H0, int W0) {
  __shared__ float red[kWarps];
  const int k = blockIdx.x, b = blockIdx.y, HW = H0 * W0;
  const float* l = logits + ((size_t)b * K + k) * HW;
  float m = -INFINITY;
  for (int p = threadIdx.x; p < HW; p += kThreads) m = fmaxf(m, l[p]);
  m = block_reduce(m, true, red);
  float s = 0.0f, su = 0.0f, sv = 0.0f;
  for (int p = threadIdx.x; p < HW; p += kThreads) {
    const float e = expf(l[p] - m);
    s += e;
    su += e * (float)(p % W0);
    sv += e * (float)(p / W0);
  }
  s = block_reduce(s, false, red);
  su = block_reduce(su, false, red);
  sv = block_reduce(sv, false, red);
  if (threadIdx.x == 0) {
    out[((size_t)b * K + k) * 2 + 0] = su / s;
    out[((size_t)b * K + k) * 2 + 1] = sv / s;
  }
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// (a): any M_i and C_i, N % 16 == 0, w_i with C_i rounded up to 16 rows (the
// wrapper checks); in_int8 selects int8 branch inputs.
extern "C" int hrnet_head_branch_conv(const void* x1, const void* x2, const void* x3,
                                      const void* w1, const void* w2, const void* w3, void* y1,
                                      void* y2, void* y3, int M1, int M2, int M3, int C1,
                                      int C2, int C3, int N, int in_int8, void* stream) {
  BranchConvArgs a{};
  const void* xs[3] = {x1, x2, x3};
  const void* ws[3] = {w1, w2, w3};
  void* ys[3] = {y1, y2, y3};
  const int Ms[3] = {M1, M2, M3}, Cs[3] = {C1, C2, C3};
  a.first_block[0] = 0;
  for (int i = 0; i < 3; ++i) {
    a.x[i] = xs[i];
    a.w[i] = static_cast<const bf16*>(ws[i]);
    a.y[i] = static_cast<bf16*>(ys[i]);
    a.M[i] = Ms[i];
    a.C[i] = Cs[i];
    a.first_block[i + 1] = a.first_block[i] + (Ms[i] + kRows - 1) / kRows;
  }
  a.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cmax = C1 > C2 ? (C1 > C3 ? C1 : C3) : (C2 > C3 ? C2 : C3);
  const size_t smem = branch_smem_bytes(cmax);
  const auto kernel = in_int8 ? branch_conv_kernel<signed char> : branch_conv_kernel<bf16>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.first_block[3], kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// (b): any C0, N % 16 == 0, K <= 128, every h_i, w_i >= 2, w0 with C0 rounded
// up to 16 rows (the wrapper checks); in_int8 selects an int8 branch 0.
extern "C" int hrnet_head_logits(const void* x0, const void* w0, const void* y1, const void* y2,
                                 const void* y3, const void* taps, const void* b_head,
                                 const void* w_final, const void* b_final, const void* temp,
                                 void* logits, int B, int H0, int W0, int C0, int h1, int w1,
                                 int h2, int w2, int h3, int w3, int N, int K, int L,
                                 int in_int8, void* stream) {
  LogitsArgs a{x0,
               static_cast<const bf16*>(w0),
               {static_cast<const bf16*>(y1), static_cast<const bf16*>(y2),
                static_cast<const bf16*>(y3)},
               static_cast<const float*>(taps),
               static_cast<const float*>(b_head),
               static_cast<const bf16*>(w_final),
               static_cast<const float*>(b_final),
               static_cast<const float*>(temp),
               static_cast<float*>(logits),
               H0, W0, C0,
               {h1, h2, h3},
               {w1, w2, w3},
               N, K, L};
  const size_t smem = logits_smem_bytes(C0, N);
  const bool tiles = C0 % 16 == 0 && K <= kKPad;
  const auto kernel = in_int8 ? (tiles ? head_logits_tiles_kernel<signed char>
                                       : head_logits_kernel<signed char>)
                              : (tiles ? head_logits_tiles_kernel<bf16> : head_logits_kernel<bf16>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H0 * W0 + kRows - 1) / kRows, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// (c)
extern "C" int hrnet_softmax_decode(const void* logits, void* out, int B, int K, int H0, int W0,
                                    void* stream) {
  softmax_decode_kernel<<<dim3(K, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<float*>(out), K, H0, W0);
  return (int)cudaGetLastError();
}
