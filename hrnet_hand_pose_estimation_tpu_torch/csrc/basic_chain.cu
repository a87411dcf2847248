// One BN-folded BasicBlock of an HRNet stage 2-4 branch, fused into one launch.
//
// Replaces the TPU kernel ops/pallas/fused_bottleneck.py::fused_basic_chain
// (body _basic_block_body_tb): per block
//   t = bf16(relu(conv3x3_1(x) + b1)),  y = bf16(relu((conv3x3_2(t) + b2) + x)),
// bf16 activations, f32 sums, t and y each rounded once, as the TPU kernel
// rounds.  A branch chain of n blocks is n launches of this kernel
// (ops/kernels/fused_bottleneck.py::fused_basic_chain).
//
// What bounds it on the H100: a 3x3 conv over C channels does 18*C^2
// operations per pixel against 4*C bytes of bf16 in and out, ~4.5*C per
// byte: above the card's ~295 bf16 FLOP per byte ridge from C = 64 on, so
// the tensor cores bound every branch but the 32-wide one, which is close.
// The design keeps t in shared memory (it never touches device memory, as in
// the TPU kernel) and runs both convs on the tensor cores through 16x16x16
// WMMA tiles.  It pays for its simplicity with recomputation (conv1 on the
// tile's halo ring and on the wrapped columns of the flattened layout below),
// with the tensor between blocks going through device memory (one launch per
// block, where the TPU kernel kept the chain in VMEM), and with weight
// fragments read from L1/L2 by every warp task (a 3x3 at C = 256 is 1.18 MB,
// more than shared memory holds); wgmma, TMA, weights staged in shared
// memory and one launch per chain are later work.
//
// Tiling: one CUDA block = one sample x a TH-row x TW-column output tile
// (TW = min(W, 32), TH chosen by the host so that shared memory fits).  The
// input halo, (TH+4) x (TW+4) pixels, is staged in shared memory row-major
// with row width HWd = TW + 4 and 0 outside the image.  In that flattened
// layout a 3x3 tap is a constant row shift (dy*HWd + dx), so any 16
// consecutive rows form a WMMA A tile for every tap, whatever W is (the 8-
// and 16-wide branches are narrower than a 16-pixel tile): the convs are
// computed on all rows of a range, and the rows that fall on the halo's
// wrapped columns are computed and never used.  conv1 covers the
// (TH+2) x (TW+2) ring conv2 reads, and t is set to 0 outside the image:
// conv2's zero padding applies to t, not to x.  Each warp task is an
// MR x NR block of 16x16 tiles, so a weight fragment read from L2 serves MR
// A tiles.
#include "common.cuh"

namespace hrnet {
namespace {

struct BasicArgs {
  const bf16* x;   // (B, H, W, C)
  bf16* out;       // (B, H, W, C)
  const bf16* w1;  // (3, 3, C, C) HWIO
  const float* b1;
  const bf16* w2;
  const float* b2;
  int H, W, C;
  int TH, TW, HWd;  // tile rows and columns, halo row width TW + 4
  int M1, M2;       // rows computed by conv1 and by conv2 (multiples of 16)
  int XR;           // rows of the staged input halo
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// The flattened layout.  Halo row L = hr * HWd + hc holds image pixel
// (y0 - 2 + hr, x0 - 2 + hc).  conv1's row q is halo row q + HWd + 1 and
// conv2's row q is halo row q + 2*HWd + 2, so tap (dy, dx) of either reads
// its source at row q + dy*HWd + dx.  M1 >= M2 + 2*HWd + 2 keeps every row
// conv2 reads inside conv1's rows, and XR >= M1 + 2*HWd + 2 every row conv1
// reads inside the staged halo.
__host__ inline BasicArgs geometry(int H, int W, int C, int TH) {
  BasicArgs a{};
  a.H = H;
  a.W = W;
  a.C = C;
  a.TH = TH;
  a.TW = W < 32 ? W : 32;
  a.HWd = a.TW + 4;
  a.M2 = round16((TH - 1) * a.HWd + a.TW);
  a.M1 = round16(a.M2 + 2 * a.HWd + 2);
  const int halo = (TH + 4) * a.HWd;
  a.XR = halo > a.M1 + 2 * a.HWd + 2 ? halo : a.M1 + 2 * a.HWd + 2;
  return a;
}

__host__ inline size_t smem_bytes(const BasicArgs& a) {
  return (size_t)(a.XR + a.M1) * (a.C + kRowPad) * sizeof(bf16) +
         (size_t)kWarps * 256 * sizeof(float);
}

// The rows x C f32 sums of a 3x3 conv over a flattened source in shared
// memory (output row q, tap (dy, dx) reads source row q + dy*HWd + dx) with
// the (3, 3, C, C) weights read from global memory; epi(row0, col0, scratch,
// lane) consumes each finished 16x16 tile from the warp's f32 scratch.
template <int MR, int NR, class Epi>
__device__ inline void conv3x3_rows(const bf16* src, int ld, int rows, const bf16* w, int C,
                                    int HWd, float* scratch, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntm = rows / 16, ntn = C / 16;
  const int groups_m = (ntm + MR - 1) / MR, groups_n = ntn / NR;
  FragA fa;
  FragB fb[NR];
  FragC acc[MR][NR];
  for (int task = warp; task < groups_m * groups_n; task += kWarps) {
    const int mt0 = (task / groups_n) * MR, nt0 = (task % groups_n) * NR;
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < NR; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int tap = 0; tap < 9; ++tap) {
      const bf16* arow = src + (size_t)((tap / 3) * HWd + tap % 3) * ld;
      const bf16* wtap = w + (size_t)tap * C * C;
      for (int k = 0; k < C; k += 16) {
#pragma unroll
        for (int j = 0; j < NR; ++j)
          wmma::load_matrix_sync(fb[j], wtap + (size_t)k * C + (nt0 + j) * 16, C);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          if (mt0 + i < ntm) {
            wmma::load_matrix_sync(fa, arow + (size_t)(mt0 + i) * 16 * ld + k, ld);
#pragma unroll
            for (int j = 0; j < NR; ++j) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      if (mt0 + i >= ntm) continue;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        epi((mt0 + i) * 16, (nt0 + j) * 16, scratch, lane);
        __syncwarp();
      }
    }
  }
}

template <int MR, int NR>
__global__ void __launch_bounds__(kThreads) basic_block_kernel(BasicArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = a.C + kRowPad;
  bf16* xs = reinterpret_cast<bf16*>(smem);   // XR x ld: the input halo
  bf16* ts = xs + (size_t)a.XR * ld;          // M1 x ld: t, conv1's rows
  float* scratch = reinterpret_cast<float*>(ts + (size_t)a.M1 * ld) + (threadIdx.x / 32) * 256;

  const int tiles_x = (a.W + a.TW - 1) / a.TW;
  const int x0 = (blockIdx.x % tiles_x) * a.TW;
  const int y0 = (blockIdx.x / tiles_x) * a.TH;
  const size_t img = (size_t)blockIdx.y * a.H * a.W;
  const int HWd = a.HWd;

  // -- stage the input halo; pixels outside the image and slack rows are 0
  const int vpr = a.C / 8, halo = (a.TH + 4) * HWd;
  for (int i = threadIdx.x; i < a.XR * vpr; i += kThreads) {
    const int r = i / vpr, v = i % vpr;
    const int gy = y0 - 2 + r / HWd, gx = x0 - 2 + r % HWd;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < halo && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
      val = *reinterpret_cast<const uint4*>(a.x + (img + (size_t)gy * a.W + gx) * a.C + v * 8);
    *reinterpret_cast<uint4*>(xs + (size_t)r * ld + v * 8) = val;
  }
  __syncthreads();

  // -- t = relu(conv1(x) + b1) on conv1's rows, 0 outside the image
  conv3x3_rows<MR, NR>(xs, ld, a.M1, a.w1, a.C, HWd, scratch,
                       [&](int row0, int col0, const float* s, int lane) {
    for (int e = lane; e < 256; e += 32) {
      const int q = row0 + e / 16, n = col0 + e % 16;
      const int L = q + HWd + 1;
      const int gy = y0 - 2 + L / HWd, gx = x0 - 2 + L % HWd;
      const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const float v = fmaxf(s[e] + a.b1[n], 0.0f);
      ts[(size_t)q * ld + n] = __float2bfloat16(inside ? v : 0.0f);
    }
  });
  __syncthreads();

  // -- out = relu((conv2(t) + b2) + x) on the tile's pixels
  conv3x3_rows<MR, NR>(ts, ld, a.M2, a.w2, a.C, HWd, scratch,
                       [&](int row0, int col0, const float* s, int lane) {
    for (int e = lane; e < 256; e += 32) {
      const int q = row0 + e / 16, n = col0 + e % 16;
      const int L = q + 2 * HWd + 2;
      const int oy = L / HWd - 2, ox = L % HWd - 2;
      const int gy = y0 + oy, gx = x0 + ox;
      if (ox < 0 || ox >= a.TW || oy >= a.TH || gy >= a.H || gx >= a.W) continue;
      float v = s[e] + a.b2[n];
      v += __bfloat162float(xs[(size_t)L * ld + n]);
      a.out[(img + (size_t)gy * a.W + gx) * a.C + n] = __float2bfloat16(fmaxf(v, 0.0f));
    }
  });
}

template <int MR, int NR>
int launch(const BasicArgs& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(basic_block_kernel<MR, NR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.W + a.TW - 1) / a.TW) * ((a.H + a.TH - 1) / a.TH), B);
  basic_block_kernel<MR, NR><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// Launch one folded BasicBlock on PyTorch's stream.  C % 16 == 0 (the
// wrapper checks).  The tile height is the largest of 8, 4, 2, 1 rows whose
// shared memory leaves room for two blocks on an SM, else the largest that
// fits one.  Returns cudaGetLastError().
extern "C" int hrnet_basic_block(const void* x, void* out, const void* w1, const void* b1,
                                 const void* w2, const void* b2, int B, int H, int W, int C,
                                 void* stream) {
  const size_t limits[2] = {113 * 1024, 227 * 1024};   // two blocks per SM, one
  BasicArgs a{};
  bool found = false;
  for (size_t limit : limits) {
    for (int th = 8; th >= 1 && !found; th /= 2) {
      if (th > H && th > 1) continue;
      a = geometry(H, W, C, th);
      found = smem_bytes(a) <= limit;
    }
    if (found) break;
  }
  if (!found) return (int)cudaErrorInvalidValue;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // warp tasks of MR x NR tiles: enough tasks for 8 warps at small C, more
  // reuse of each weight fragment at large C
  const int ntn = C / 16;
  if (ntn % 2) return launch<2, 1>(a, B, s);
  if (ntn <= 6) return launch<2, 2>(a, B, s);
  return launch<4, 2>(a, B, s);
}
