// HRNet's head, first version: upsample, then the head convs at full
// resolution, to logits.
//
// Replaces the TPU kernel ops/pallas/fused_head_decode.py::fused_head_decode
// (v1, body _kernel).  Per sample, on square maps (h0 = w0):
//   up_i   = bf16(x_i @ bf16(kron(W_i, W_i)^T))   branches 1..3, f32 sums
//   feat   = concat(x_0, up_1, up_2, up_3)        (Ctot = 480 for w32)
//   y      = bf16(relu(feat @ w_head + b_head))
//   logits = (y @ w_final + b_final) * temp       -> (B, K, h0*w0) f32
// and the spatial softmax + soft-argmax of those logits is the launch
// hrnet_softmax_decode of csrc/fused_head_decode.cu, which computes exactly
// the TPU kernel's last step (max-subtracted exp, sums, one division).
//
// The dense Kronecker matrix is not carried over: row p = (py, px) of it
// has at most four nonzero entries, bf16(f32(W[py, sy] * W[px, sx])) for sy
// in {lo_y, hi_y} and sx in {lo_x, hi_x}, so each upsampled pixel is a
// gather of four taps whose weights are exactly those entries, summed in f32
// and rounded to bf16.  Only the order of the f32 sum differs from the
// dense product (whose other terms are products with 0).
//
// What bounds it on the H100: ~1.97 GFLOP per sample of bf16 products (the
// 480 x 480 head conv and the 480 -> K final conv at 64 x 64) against ~0.5
// MB of branch tensors in: the tensor cores.  Design: one CUDA block = one
// sample x 64 output pixels.  It builds its 64 x Ctot feat tile in shared
// memory (x_0 copied, the upsampled branches gathered, 8 channels per
// thread), runs the head GEMM on 16x16x16 bf16 WMMA tiles (each warp one
// 16-column strip of all 64 rows, so a w_head fragment read from L2 serves
// four A tiles), keeps relu(head) in shared memory in bf16, and runs the
// final conv from there; feat and y never reach device memory, the logits
// do (0.34 MB per sample for the decode launch).  w_head is read from L2 by
// every block, with no TMA or wgmma: later work.
#include "common.cuh"

namespace hrnet {
namespace {

constexpr int kPix = 64;   // output pixels per block

struct HeadV1Args {
  const bf16* x[4];       // (B, s_i, s_i, C_i) NHWC; s_0 = H0
  const float* taps;      // (3 branches, 4 fields {lo, hi, wa, wb}, H0)
  const bf16* w_head;     // (Ctot, N), in x out
  const float* b_head;    // (N,)
  const bf16* w_final;    // (N, Kp), columns K..Kp-1 zero
  const float* b_final;   // (K,)
  const float* temp;      // ()
  float* logits;          // (B, K, H0*H0)
  int H0;
  int s[4], C[4];
  int off[5];             // channel offset of each branch in feat; off[4] = Ctot
  int N, K, Kp;
};

__host__ inline size_t v1_smem_bytes(int ctot, int n) {
  return (size_t)kPix * (ctot + kRowPad + n + kRowPad) * sizeof(bf16) +
         (size_t)kWarps * 256 * sizeof(float);
}

__global__ void __launch_bounds__(kThreads) head_v1_kernel(HeadV1Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ctot = a.off[4];
  const int ldf = ctot + kRowPad, ldh = a.N + kRowPad;
  bf16* fs = reinterpret_cast<bf16*>(smem);   // kPix x ldf: feat
  bf16* hs = fs + kPix * ldf;                 // kPix x ldh: relu(head) in bf16
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(hs + kPix * ldh) + warp * 256;
  const int H0 = a.H0, HW = H0 * H0, b = blockIdx.y, p0 = blockIdx.x * kPix;

  // -- the feat tile: x_0 copied, branches 1..3 upsampled from their taps
  const int vpr = ctot / 8;
  for (int i = threadIdx.x; i < kPix * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * 8, p = p0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (p < HW) {
      int br = 0;
      while (c >= a.off[br + 1]) ++br;
      const int cc = c - a.off[br];
      if (br == 0) {
        val = *reinterpret_cast<const uint4*>(a.x[0] + ((size_t)b * HW + p) * a.C[0] + cc);
      } else {
        const int py = p / H0, px = p % H0;
        const float* tp = a.taps + (size_t)(br - 1) * 4 * H0;
        const int ys[2] = {(int)tp[py], (int)tp[H0 + py]};
        const int xs[2] = {(int)tp[px], (int)tp[H0 + px]};
        const float wy[2] = {tp[2 * H0 + py], tp[3 * H0 + py]};
        const float wx[2] = {tp[2 * H0 + px], tp[3 * H0 + px]};
        const int s = a.s[br], C = a.C[br];
        const bf16* base = a.x[br] + (size_t)b * s * s * C + cc;
        float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int dy = 0; dy < 2; ++dy) {
          for (int dx = 0; dx < 2; ++dx) {
            // the kron_interp entry: one f32 product, rounded to bf16
            const float m = __bfloat162float(__float2bfloat16(__fmul_rn(wy[dy], wx[dx])));
            const uint4 raw = *reinterpret_cast<const uint4*>(
                base + ((size_t)ys[dy] * s + xs[dx]) * C);
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(h[j]);
              acc[2 * j] += f.x * m;   // a bf16 x bf16 product is exact in f32
              acc[2 * j + 1] += f.y * m;
            }
          }
        }
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&val);
        for (int j = 0; j < 4; ++j) o[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
      }
    }
    *reinterpret_cast<uint4*>(fs + r * ldf + c) = val;
  }
  __syncthreads();

  // -- y = bf16(relu(feat @ w_head + b_head)): warp task = one 16-column
  //    strip of all kPix rows
  FragA fa;
  FragB fb;
  FragC acc[kPix / 16];
  for (int nt = warp; nt < a.N / 16; nt += kWarps) {
#pragma unroll
    for (int i = 0; i < kPix / 16; ++i) wmma::fill_fragment(acc[i], 0.0f);
    for (int k = 0; k < ctot; k += 16) {
      wmma::load_matrix_sync(fb, a.w_head + (size_t)k * a.N + nt * 16, a.N);
#pragma unroll
      for (int i = 0; i < kPix / 16; ++i) {
        wmma::load_matrix_sync(fa, fs + i * 16 * ldf + k, ldf);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPix / 16; ++i) {
      wmma::store_matrix_sync(scratch, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int n = nt * 16 + e % 16;
        hs[(i * 16 + e / 16) * ldh + n] = __float2bfloat16(fmaxf(scratch[e] + a.b_head[n], 0.0f));
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // -- logits = (y @ w_final + b_final) * temp: warp task = one 16x16 tile
  const float temp = *a.temp;
  const int nkt = a.Kp / 16;
  for (int task = warp; task < (kPix / 16) * nkt; task += kWarps) {
    const int mt = task / nkt, kt = task % nkt;
    wmma::fill_fragment(acc[0], 0.0f);
    for (int k = 0; k < a.N; k += 16) {
      wmma::load_matrix_sync(fa, hs + mt * 16 * ldh + k, ldh);
      wmma::load_matrix_sync(fb, a.w_final + (size_t)k * a.Kp + kt * 16, a.Kp);
      wmma::mma_sync(acc[0], fa, fb, acc[0]);
    }
    wmma::store_matrix_sync(scratch, acc[0], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int c = e / 16, r = e % 16;   // consecutive lanes: consecutive pixels
      const int kk = kt * 16 + c, p = p0 + mt * 16 + r;
      if (kk < a.K && p < HW)
        a.logits[((size_t)b * a.K + kk) * HW + p] = (scratch[r * 16 + c] + a.b_final[kk]) * temp;
    }
    __syncwarp();
  }
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// The head of v1 to logits on PyTorch's stream.  Square maps, every C_i % 8
// == 0, Ctot % 16 == 0, N % 16 == 0, Kp = K rounded up to 16, branches
// 16-byte and w_head 32-byte aligned (the wrapper checks).  Returns
// cudaGetLastError().
extern "C" int hrnet_head_v1_logits(const void* x0, const void* x1, const void* x2,
                                    const void* x3, const void* taps, const void* w_head,
                                    const void* b_head, const void* w_final, const void* b_final,
                                    const void* temp, void* logits, int B, int H0, int s1, int s2,
                                    int s3, int C0, int C1, int C2, int C3, int N, int K, int Kp,
                                    void* stream) {
  HeadV1Args a{};
  const void* xs[4] = {x0, x1, x2, x3};
  const int ss[4] = {H0, s1, s2, s3}, cs[4] = {C0, C1, C2, C3};
  a.off[0] = 0;
  for (int i = 0; i < 4; ++i) {
    a.x[i] = static_cast<const bf16*>(xs[i]);
    a.s[i] = ss[i];
    a.C[i] = cs[i];
    a.off[i + 1] = a.off[i] + cs[i];
  }
  a.taps = static_cast<const float*>(taps);
  a.w_head = static_cast<const bf16*>(w_head);
  a.b_head = static_cast<const float*>(b_head);
  a.w_final = static_cast<const bf16*>(w_final);
  a.b_final = static_cast<const float*>(b_final);
  a.temp = static_cast<const float*>(temp);
  a.logits = static_cast<float*>(logits);
  a.H0 = H0;
  a.N = N;
  a.K = K;
  a.Kp = Kp;
  const size_t smem = v1_smem_bytes(a.off[4], N);
  cudaError_t err = cudaFuncSetAttribute(head_v1_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H0 * H0 + kPix - 1) / kPix, B);
  head_v1_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
