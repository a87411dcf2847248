// HRNet's head + spatial softmax + soft-argmax, in one launch.
//
// Replaces the TPU kernel ops/pallas/fused_head_decode.py::fused_head_decode_v2
// (body _kernel_v2).  The head's 1x1 conv (BN folded) distributes over the
// channel concat and commutes with the align-corners bilinear upsample, so
// each branch is convolved at its native resolution with its row slice of
// the folded kernel, and the results are upsampled and summed, with the TPU
// kernel's rounding points:
//   y_i    = bf16(x_i @ W_i)                          i = 1..3, f32 sums
//   up_i   = H-mix_f32(W-mix(y_i))                    W-mix weights in bf16
//   h      = bf16(relu(x_0 @ W_0 + sum_i up_i + b_head))
//   logits = (h @ bf16(w_final) + b_final) * temp
//   coords = sum_p softmax_p(logits) * (p % W0, p / W0)      -> (B, K, 2)
//
// What bounds it on the H100: ~0.37 GFLOP per flagship sample (w32, 64x64,
// K = 21) against ~0.5 MB of branch tensors in and 168 bytes out, ~700 FLOP
// per byte: the tensor cores bound the function.  The first version ran it
// as three launches that wrote y_1..y_3 and the logits to device memory and
// gathered 12 scalar samples per head output from L1/L2; it took ~100x its
// bound.  This one keeps every intermediate on chip:
//
// - Grid (bands, B), a thread-block cluster of `bands` (<= 8) blocks per
//   sample; block `band` owns RB output rows and walks them in passes of RP
//   rows (one pass on the flagship: 8 rows x 64 columns).  A pass stages its
//   x_0 rows and the source rows of x_1..x_3 its bilinear taps reach in
//   shared memory once (bf16; int8 inputs cast on load, exact for |v| <= 127).
//   Neighbouring bands recompute the branch rows they share.
// - The head width N is walked in chunks of 32 columns, back to back with
//   the final conv, as flash attention walks P.V: per chunk,
//   (A) y_i[:, chunk] = x_i @ W_i[:, chunk] on mma.sync (m16n8k16 bf16,
//       ldmatrix A and B), rounded to bf16 into shared memory;
//   (B) per warp, 4 m16 tiles (16 output columns of one row each; units of
//       UR consecutive rows of one column group): x_0 @ W_0[:, chunk] +
//       b_head in the accumulators; the W-mix of each branch as an MMA whose
//       A is the column group's slice of the bf16 align-corners matrix (at
//       most 32 source columns; fragments built once per block) and whose B
//       is one staged y_i row, kept in registers for the unit's next row,
//       which reads one or both of the same source rows; the H-mix as two
//       f32 FMAs per element; ReLU and bf16 in registers; the accumulators
//       then ARE the A operand of logits += h_chunk @ w_final[chunk, :],
//       held in registers.
//   The weights stream through a ring of slabs in shared memory (W_1..W_3
//   in slabs of up to `slab_rows` rows, then W_0 with the chunk's w_final
//   rows), each slab one bulk copy completing on an mbarrier; the wrapper
//   lays the weights out by chunk for it (fused_head_decode.py::
//   slab_layout).  No weight is read from global memory in an MMA loop,
//   and nothing is written to device memory but the coordinates.
// - Epilogue: per joint, each block forms over its pixels the max m, sum e,
//   sum e*u and sum e*v with e = exp(l - m); the cluster combines the bands'
//   partials through distributed shared memory, rescaled by exp(m - M), and
//   rank 0 writes (B, K, 2).  No workspace, no atomics, no second launch.
// What holds it back (measured on the H100, PERF.md): a block is
// latency-bound at one block of 8 warps per SM (255 registers): short
// dependent ldmatrix -> mma -> FMA chains, and ~490 KB of weights streamed
// per 512-pixel pass (with every MMA removed a w32 block still spends ~90K
// of its ~330K cycles).
// K > 32 runs the pass once per group of 32 joints (every pass's partials
// merge the same way); K <= 128, the TPU kernel's limit.
//
// Widths: any C_i (weights padded by the wrapper to Cp_i = C_i rounded up
// to 16 rows, the staged rows zero past C_i), any head width (N padded to a
// multiple of 32 with zero columns: relu(0) = 0 adds nothing), any map with
// h_i, w_i >= 2 whose W-mix window fits 32 source columns.  The launch plan
// (bands, pass rows, source rows per pass, slab rows, ring depth, shared
// memory) is made in Python, ops/kernels/fused_head_decode.py::head_plan;
// the entry checks it.
//
// int8-input mode (the int8 serving path's HEAD_SCALES_KEY, the TPU kernel's
// input_scales): the four branches arrive as int8 (B, h, w, C_i) with
// x_i ~= sa_i * xq_i; the wrapper folds sa_i into W_i in f32 before the bf16
// cast.  The branch tensors are then half the bytes.
#include <math.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "conv_mainloop.cuh"

namespace hrnet {
namespace {

namespace cg = cooperative_groups;

constexpr int kNC = 32;         // head columns per chunk
constexpr int kLdN = kNC + 8;   // bf16 per y_i row of 32 columns: 80 bytes, an odd multiple of 16
constexpr int kMT = 4;          // m16 head tiles per warp in a pass (8 warps: <= 32 per pass)
constexpr int kUMax = 6;        // m16 tiles per warp of one branch GEMM (<= 12 per branch)
constexpr int kJG = 32;         // joints per group (4 n8 tiles of logits)
constexpr int kPadRows = 32;    // zero rows past each y_i buffer (W-mix windows read <= 30 past)
constexpr int kMaxBands = 8;    // the portable cluster size

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

// two 8x8 b16 matrices transposed; lanes 0-15 give the row addresses
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// A slab row is 32 bf16 (64 bytes, no pad); its 16-byte piece v is stored at
// v ^ ((r >> 1) & 3) (the wrapper lays the weights out so), which puts the
// 8 rows of an ldmatrix phase on 8 different bank groups.  The address of
// columns cg * 8 .. of row r:
__device__ __forceinline__ unsigned slab_addr(unsigned base, int r, int cg) {
  return base + r * 64 + ((cg ^ ((r >> 1) & 3)) << 4);
}

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

struct HeadArgs {
  const void* x[4];        // branch i: (B, h_i, w_i, C_i), bf16 or int8
  const bf16* wt[4];       // (Np / 32, cp_i, 32): branch i's rows of the folded head conv by chunk
  const float* b_head;     // (Np), zero past N
  const bf16* w_final;     // (KG, Np / 32, 32, 32): the final conv by joint group and chunk
  const float* b_final;    // (K)
  const float* temp;       // ()
  const float* taps;       // (3 branches, 2 axes {rows, cols}, 3 fields {lo, a, b}, L)
  float* out;              // (B, K, 2)
  int h[4], w[4], C[4], cp[4];   // branch i's map, channels, channels rounded up to 16
  int Np, K, KG, L;
  int bands, RB, RP, UR, G, KW, slab_rows, stages;
  int SR[4];               // source rows of branches 1..3 staged per pass, at most
  int S[4];                // weight slabs per chunk of branches 1..3
  // shared-memory layout, bytes from the start
  int off_xs[4], off_ys[4], off_ring, off_bh, off_rowtab, off_atab, off_cw, off_bt, off_mbar,
      off_red, off_part;
  int smem;
};

// per-branch values the rolled loops read from shared memory (branches 1..3)
enum { kBtXs, kBtLdx, kBtMt, kBtFirst, kBtS, kBtCp, kBtYs, kBtW, kBtFields };

// The shared-memory layout of a plan (ops/kernels/fused_head_decode.py::
// _head_smem computes the same total): the staged x_0 rows and x_i source
// rows (rows of cp_i + 8 bf16), y_1..y_3 of a chunk (rows of 40 bf16, 32
// zero rows past), the weight ring (rows of 64 bytes), b_head, the row taps
// of a pass, the W-mix A fragments, the branch table, the ring's mbarriers,
// the reduction scratch and the joints' partials.
__host__ inline void head_layout(HeadArgs& a) {
  int off = 0;
  auto take = [&](long bytes) {
    const int at = off;
    off += (int)((bytes + 127) / 128 * 128);
    return at;
  };
  a.off_xs[0] = take(2L * a.RP * a.w[0] * (a.cp[0] + 8));
  for (int i = 1; i < 4; ++i) a.off_xs[i] = take(2L * round16(a.SR[i] * a.w[i]) * (a.cp[i] + 8));
  a.off_ys[0] = 0;
  for (int i = 1; i < 4; ++i)
    a.off_ys[i] = take(2L * (round16(a.SR[i] * a.w[i]) + kPadRows) * kLdN);
  a.off_ring = take(64L * a.stages * a.slab_rows);
  a.off_bh = take(4L * a.Np);
  a.off_rowtab = take(16L * 3 * a.RP);
  a.off_atab = take(16L * 3 * a.G * a.KW * 32);
  a.off_cw = take(4L * 3 * a.G);
  a.off_bt = take(4L * 4 * kBtFields + 8L * 4);
  a.off_mbar = take(8L * a.stages);
  a.off_red = take(4L * (kWarps * kJG * 3 + kJG));
  a.off_part = take(16L * a.KG * kJG);
  a.smem = off;
}

// Stage `rows` shared rows (ld bf16 apart, cp channels) from `src`, npx
// pixels of C channels; rows past npx and channels past C are 0.
template <typename T>
__device__ inline void stage_rows(bf16* dst, int ld, const T* src, int npx, int rows, int C,
                                  int cp) {
  const int vpr = cp / 8;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, v = i - r * vpr;
    bf16* d = dst + r * ld + v * 8;
    if (std::is_same<T, bf16>::value && C % 8 == 0) {
      const bool in = r < npx;
      cp_async16(smem_u32(d), in ? static_cast<const void*>(src + (size_t)r * C + v * 8)
                                 : static_cast<const void*>(src), in);
    } else {
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < npx) val = load8_bf16(src + (size_t)r * C, v * 8, C);
      *reinterpret_cast<uint4*>(d) = val;
    }
  }
}

// t = A (16 output columns x the window of source columns, KW k16 steps)
// x y_q rows row * wq + cw .. of the chunk: the W-mix of one source row
__device__ __forceinline__ void wmix(float (&t)[4][4], const uint4 (&af)[2], unsigned ysq, int row,
                                     int wq, int cw, int KW, int lane) {
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[jn][e] = 0.0f;
#pragma unroll
  for (int kw = 0; kw < 2; ++kw) {
    if (kw >= KW) break;
    const unsigned fa[4] = {af[kw].x, af[kw].y, af[kw].z, af[kw].w};
    const unsigned yb =
        ysq + ((row * wq + cw + kw * 16 + (lane & 15)) * kLdN + (lane >> 4) * 8) * 2;
    unsigned r0[4], r1[4];
    ldsm_x4_trans(r0, yb);
    ldsm_x4_trans(r1, yb + 32);
    const unsigned b0[2] = {r0[0], r0[1]}, b1[2] = {r0[2], r0[3]};
    const unsigned b2[2] = {r1[0], r1[1]}, b3[2] = {r1[2], r1[3]};
    mma_bf16(t[0], fa, b0);
    mma_bf16(t[1], fa, b1);
    mma_bf16(t[2], fa, b2);
    mma_bf16(t[3], fa, b3);
  }
}

// kWhole: every branch's rows of a chunk fit one slab, so a branch GEMM
// starts and ends within one slab and its accumulators are dead outside it
// (registers for the head); else they persist across the branch's slabs.
template <typename T, bool kWhole>
__global__ void __launch_bounds__(kThreads, 1) head_kernel(HeadArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y, H0 = a.h[0], W0 = a.w[0], G = a.G, L = a.L, UR = a.UR;
  const int y_first = blockIdx.x * a.RB, y_end = min(H0, y_first + a.RB);

  bf16* xs0 = reinterpret_cast<bf16*>(smem + a.off_xs[0]);
  unsigned char* ring = smem + a.off_ring;
  float* bh = reinterpret_cast<float*>(smem + a.off_bh);
  float4* rowtab = reinterpret_cast<float4*>(smem + a.off_rowtab);   // [3][RP]
  uint4* atab = reinterpret_cast<uint4*>(smem + a.off_atab);         // [3][G][KW][32]
  int* cwtab = reinterpret_cast<int*>(smem + a.off_cw);              // [3][G]
  int* bt = reinterpret_cast<int*>(smem + a.off_bt);                 // [4][kBtFields]
  const bf16** wtab = reinterpret_cast<const bf16**>(bt + 4 * kBtFields);   // [4]
  float* red = reinterpret_cast<float*>(smem + a.off_red);           // [8][32][3], then max[32]
  float* part = reinterpret_cast<float*>(smem + a.off_part);         // [KG * 32][4]
  const float* taps = a.taps;
  auto tap = [&](int i, int axis, int field, int d) {
    return __ldg(taps + ((size_t)((i - 1) * 2 + axis) * 3 + field) * L + d);
  };

  // -- once per block: b_head, the W-mix A fragments, the branch table,
  // zeroed y buffers (the W-mix window reads rows no GEMM writes: 0 *
  // garbage could be NaN), the joints' partials
  for (int i = tid; i < a.Np; i += kThreads) bh[i] = a.b_head[i];
  for (int e = tid; e < 3 * G; e += kThreads) cwtab[e] = (int)tap(e / G + 1, 1, 0, (e % G) * 16);
#pragma unroll 1
  for (int e = tid; e < 3 * G * a.KW * 32; e += kThreads) {
    // lane ln of the A fragment (16 output columns x 16 source columns) of
    // branch i, column group xg, k16 step kw: A[X][c] = the bf16 W-mix
    // weight of source column cw + c in output column X
    const int ln = e % 32, kw = (e / 32) % a.KW, xg = (e / (32 * a.KW)) % G;
    const int i = e / (32 * a.KW * G) + 1;
    const int cw = (int)tap(i, 1, 0, xg * 16);
    unsigned r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int X = xg * 16 + (ln >> 2) + 8 * (q & 1);
      const int c = cw + kw * 16 + 2 * (ln & 3) + 8 * (q >> 1);
      float v[2] = {0.0f, 0.0f};
      if (X < W0) {
        const int lo = (int)tap(i, 1, 0, X);
        const float wa = tap(i, 1, 1, X), wb = tap(i, 1, 2, X);
        v[0] = c == lo ? wa : (c == lo + 1 ? wb : 0.0f);
        v[1] = c + 1 == lo ? wa : (c + 1 == lo + 1 ? wb : 0.0f);
      }
      r[q] = pack_bf16(v[0], v[1]);
    }
    atab[e] = make_uint4(r[0], r[1], r[2], r[3]);
  }
  if (tid < 4) {
    const int q = tid;
    int* row = bt + q * kBtFields;
    row[kBtXs] = a.off_xs[q];
    row[kBtLdx] = a.cp[q] + 8;
    row[kBtFirst] = q == 0 ? 0 : (q == 1 ? 0 : (q == 2 ? a.S[1] : a.S[1] + a.S[2]));
    row[kBtS] = a.S[q];
    row[kBtCp] = a.cp[q];
    row[kBtYs] = a.off_ys[q];
    row[kBtW] = a.w[q];
    wtab[q] = a.wt[q];
  }
#pragma unroll 1
  for (int i = 1; i < 4; ++i) {
    uint4* y = reinterpret_cast<uint4*>(smem + a.off_ys[i]);
    const int n = (round16(a.SR[i] * a.w[i]) + kPadRows) * kLdN / 8;
    for (int e = tid; e < n; e += kThreads) y[e] = make_uint4(0, 0, 0, 0);
  }
  for (int j = tid; j < a.KG * kJG; j += kThreads)
    reinterpret_cast<float4*>(part)[j] = make_float4(-INFINITY, 0.0f, 0.0f, 0.0f);
  const unsigned mbar_u = smem_u32(smem + a.off_mbar), ring_u = smem_u32(ring);
  if (tid == 0) {
    for (int st = 0; st < a.stages; ++st) mbar_init(mbar_u + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const int nchunks = a.Np / kNC, spc = a.S[1] + a.S[2] + a.S[3] + 1, J = nchunks * spc;
  // blocks start their walk of the head width at different chunks, so that
  // they do not all read the same weight lines from L2 at once
  const int c0 = (blockIdx.x * 5 + blockIdx.y) % nchunks;
  const int stage_bytes = a.slab_rows * 64;
  const float temp = *a.temp;
  float logit[kMT][4][4];
  float accA[kUMax][4];
  int kg = 0;
  unsigned ring_base = 0;   // slabs streamed so far: the next one's stage and mbarrier phase

  // the weight stream of a joint group: per chunk, the slabs of W_1, W_2,
  // W_3 (up to slab_rows rows of 32 columns each), then W_0 with the
  // chunk's 32 rows of w_final (the group's 32 joint columns).  Thread 0
  // starts the copy of slab j of the stream.
  auto fetch = [&](int j) {
    const unsigned gj = ring_base + j, stage = gj % a.stages;
    const unsigned dst = ring_u + stage * stage_bytes, mb = mbar_u + 8 * stage;
    const int jc = j / spc, s = j - jc * spc;
    const int c = (jc + c0) % nchunks;
    if (s == spc - 1) {
      const unsigned b0 = a.cp[0] * 64, b1 = kNC * 64;
      mbar_expect_tx(mb, b0 + b1);
      bulk_g2s(dst, a.wt[0] + (size_t)c * a.cp[0] * kNC, b0, mb);
      bulk_g2s(dst + b0, a.w_final + ((size_t)kg * nchunks + c) * kNC * kNC, b1, mb);
      return;
    }
    int q = 1;
    while (q < 3 && s >= bt[q * kBtFields + kBtFirst] + bt[q * kBtFields + kBtS]) ++q;
    const int cp = bt[q * kBtFields + kBtCp], k0 = (s - bt[q * kBtFields + kBtFirst]) * a.slab_rows;
    const unsigned bytes = min(a.slab_rows, cp - k0) * 64;
    mbar_expect_tx(mb, bytes);
    bulk_g2s(dst, wtab[q] + ((size_t)c * cp + k0) * kNC, bytes, mb);
  };

  for (int yp = y_first; yp < y_end; yp += a.RP) {
    const int rows = min(a.RP, y_end - yp);
    __syncthreads();   // the previous pass is done with the staged rows and tables
    // the source rows of branches 1..3 this pass reads, and its row taps
    // (the plan's SR_i bounds the count; min() only keeps a bad plan in bounds)
    int rlo[4], nr[4];
#pragma unroll
    for (int i = 1; i < 4; ++i) {
      rlo[i] = (int)tap(i, 0, 0, yp);
      nr[i] = min((int)tap(i, 0, 0, yp + rows - 1) + 2 - rlo[i], a.SR[i]);
      if (tid == 0) bt[i * kBtFields + kBtMt] = (nr[i] * a.w[i] + 15) / 16;
    }
    for (int e = tid; e < 3 * rows; e += kThreads) {
      const int i = e / rows + 1, yr = e - (i - 1) * rows;
      const int lo = (int)tap(i, 0, 0, yp + yr);
      rowtab[(i - 1) * a.RP + yr] = make_float4(__int_as_float(lo - rlo[i]), tap(i, 0, 1, yp + yr),
                                                tap(i, 0, 2, yp + yr), 0.0f);
    }
    {
      const T* x0 = static_cast<const T*>(a.x[0]) + ((size_t)b * H0 + yp) * W0 * a.C[0];
      stage_rows(xs0, a.cp[0] + 8, x0, rows * W0, rows * W0, a.C[0], a.cp[0]);
#pragma unroll 1
      for (int i = 1; i < 4; ++i) {
        const T* xi =
            static_cast<const T*>(a.x[i]) + ((size_t)b * a.h[i] + rlo[i]) * a.w[i] * a.C[i];
        stage_rows(reinterpret_cast<bf16*>(smem + a.off_xs[i]), a.cp[i] + 8, xi, nr[i] * a.w[i],
                   round16(nr[i] * a.w[i]), a.C[i], a.cp[i]);
      }
      cp_async_commit();   // waited for before the stream's first barrier
    }
    // this warp's head tiles: slot s is row s % UR of unit warp + 8 * (s / UR);
    // unit u is UR consecutive output rows of column group u % G
    const int units = G * ((rows + UR - 1) / UR);
    int sxg[kMT], syr[kMT];
    bool sok[kMT];
    unsigned xa[kMT];   // ldmatrix address of this lane's x_0 row
#pragma unroll
    for (int sl = 0; sl < kMT; ++sl) {
      const int u = warp + 8 * (sl / UR);
      sxg[sl] = u % G;
      syr[sl] = (u / G) * UR + sl % UR;
      sok[sl] = u < units && syr[sl] < rows;
      const int px = min(syr[sl], rows - 1) * W0 + min(sxg[sl] * 16 + (lane & 15), W0 - 1);
      xa[sl] = smem_u32(xs0 + px * (a.cp[0] + 8) + (lane >> 4) * 8);
    }

    for (kg = 0; kg < a.KG; ++kg) {
      const int ktiles = min(4, (a.K - kg * kJG + 7) / 8);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) logit[i][jn][e] = 0.0f;

      auto compute = [&](int j, unsigned char* st) {
        const int jc = j / spc, s = j - jc * spc;
        const int c = (jc + c0) % nchunks;
        const unsigned sw = smem_u32(st);
        if (s < spc - 1) {
          // (A) y_q[:, chunk] += x_q[:, k0 .. k0 + nrows] @ slab: m16 tiles
          // (warp >> 2) + 2v of the branch, the warp's n8 tile warp & 3
          int q = 1;
          while (q < 3 && s >= bt[q * kBtFields + kBtFirst] + bt[q * kBtFields + kBtS]) ++q;
          const int* br = bt + q * kBtFields;
          const int k0 = (s - br[kBtFirst]) * a.slab_rows, cp = br[kBtCp];
          const int nrows = min(a.slab_rows, cp - k0);
          const int ldx = br[kBtLdx], n8 = warp & 3, mq = br[kBtMt];
          const unsigned xa_q =
              smem_u32(smem + br[kBtXs]) + ((lane & 15) * ldx + k0 + (lane >> 4) * 8) * 2;
          auto gemm = [&](float (&acc)[kUMax][4]) {
#pragma unroll 1
            for (int kq = 0; kq < nrows; kq += 16) {
              // every fragment load of the k16 step before its MMAs
              unsigned bfr[2], fa[kUMax][4];
              ldsm_x2_trans(bfr, slab_addr(sw, kq + (lane & 15), n8));
#pragma unroll
              for (int v = 0; v < kUMax; ++v) {
                const int m = (warp >> 2) + 2 * v;
                if (m >= mq) break;   // warp-uniform
                ldsm_x4(fa[v], xa_q + (m * 16 * ldx + kq) * 2);
              }
#pragma unroll
              for (int v = 0; v < kUMax; ++v) {
                if ((warp >> 2) + 2 * v >= mq) break;
                mma_bf16(acc[v], fa[v], bfr);
              }
            }
          };
          // the branch's last slab: y_q = bf16(sum)
          auto store = [&](const float (&acc)[kUMax][4]) {
            bf16* ys = reinterpret_cast<bf16*>(smem + br[kBtYs]);
#pragma unroll
            for (int v = 0; v < kUMax; ++v) {
              const int m = (warp >> 2) + 2 * v;
              if (m >= mq) break;
              bf16* yd = ys + (m * 16 + g) * kLdN + n8 * 8 + 2 * t4;
              *reinterpret_cast<unsigned*>(yd) = pack_bf16(acc[v][0], acc[v][1]);
              *reinterpret_cast<unsigned*>(yd + 8 * kLdN) = pack_bf16(acc[v][2], acc[v][3]);
            }
          };
          if constexpr (kWhole) {
            float acc[kUMax][4];
#pragma unroll
            for (int v = 0; v < kUMax; ++v)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[v][e] = 0.0f;
            gemm(acc);
            store(acc);
          } else {
            if (k0 == 0) {
#pragma unroll
              for (int v = 0; v < kUMax; ++v)
#pragma unroll
                for (int e = 0; e < 4; ++e) accA[v][e] = 0.0f;
            }
            gemm(accA);
            if (k0 + nrows == cp) store(accA);
          }
          return;
        }
        // (B) the head over this warp's slots for this chunk: b_head, x_0 @ W_0
        float acc[kMT][4][4];
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const float2 bb = *reinterpret_cast<const float2*>(bh + c * kNC + jn * 8 + 2 * t4);
#pragma unroll
          for (int sl = 0; sl < kMT; ++sl) {
            acc[sl][jn][0] = bb.x;
            acc[sl][jn][1] = bb.y;
            acc[sl][jn][2] = bb.x;
            acc[sl][jn][3] = bb.y;
          }
        }
#pragma unroll 1
        for (int kq = 0; kq < a.cp[0]; kq += 16) {
          unsigned bw[4][2];
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            unsigned r[4];
            ldsm_x4_trans(r, slab_addr(sw, kq + (lane & 15), jp * 2 + (lane >> 4)));
            bw[2 * jp][0] = r[0];
            bw[2 * jp][1] = r[1];
            bw[2 * jp + 1][0] = r[2];
            bw[2 * jp + 1][1] = r[3];
          }
          unsigned fa[kMT][4];
#pragma unroll
          for (int sl = 0; sl < kMT; ++sl)
            if (sok[sl]) ldsm_x4(fa[sl], xa[sl] + kq * 2);   // warp-uniform
#pragma unroll
          for (int sl = 0; sl < kMT; ++sl) {
            if (!sok[sl]) continue;
#pragma unroll
            for (int jn = 0; jn < 4; ++jn) mma_bf16(acc[sl][jn], fa[sl], bw[jn]);
          }
        }
        // + up_q: per unit (UR consecutive output rows of one column group),
        // the W-mix of the two source rows an output row reads (an MMA over
        // the column group's window), kept in registers for the unit's next
        // row, which shares one or both of them; then the f32 H-mix taps
#pragma unroll 1
        for (int q = 1; q < 4; ++q) {
          const int* br = bt + q * kBtFields;
          const unsigned ysq = smem_u32(smem + br[kBtYs]);
          const int wq = br[kBtW];
          float t0[4][4], t1[4][4];
          uint4 af[2];
          int cw = 0, prev = -2;
#pragma unroll
          for (int sl = 0; sl < kMT; ++sl) {
            if (!sok[sl]) continue;   // warp-uniform
            if (sl % UR == 0) {       // a new unit: its column group's A fragments
              const uint4* at = atab + (((q - 1) * G + sxg[sl]) * a.KW) * 32 + lane;
              af[0] = at[0];
              af[1] = a.KW > 1 ? at[32] : af[0];
              cw = cwtab[(q - 1) * G + sxg[sl]];
              prev = -2;
            }
            const float4 rt = rowtab[(q - 1) * a.RP + syr[sl]];
            const int r0 = __float_as_int(rt.x);
            if (r0 == prev + 1) {
#pragma unroll
              for (int jn = 0; jn < 4; ++jn)
#pragma unroll
                for (int e = 0; e < 4; ++e) t0[jn][e] = t1[jn][e];
              wmix(t1, af, ysq, r0 + 1, wq, cw, a.KW, lane);
            } else if (r0 != prev) {
              wmix(t0, af, ysq, r0, wq, cw, a.KW, lane);
              wmix(t1, af, ysq, r0 + 1, wq, cw, a.KW, lane);
            }
            prev = r0;
#pragma unroll
            for (int jn = 0; jn < 4; ++jn)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[sl][jn][e] = fmaf(rt.z, t1[jn][e], fmaf(rt.y, t0[jn][e], acc[sl][jn][e]));
          }
        }
        // h = bf16(relu(acc)): the accumulators of n8 tiles 2kk, 2kk + 1 are
        // the A fragment of k16 step kk of the final conv, whose B fragments
        // (the chunk's w_final rows) come from the slab
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          unsigned bwf[4][2];
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            unsigned r[4];
            ldsm_x4_trans(r, slab_addr(sw, a.cp[0] + kk * 16 + (lane & 15), jp * 2 + (lane >> 4)));
            bwf[2 * jp][0] = r[0];
            bwf[2 * jp][1] = r[1];
            bwf[2 * jp + 1][0] = r[2];
            bwf[2 * jp + 1][1] = r[3];
          }
#pragma unroll
          for (int sl = 0; sl < kMT; ++sl) {
            if (!sok[sl]) continue;
            const float(&lo)[4] = acc[sl][2 * kk];
            const float(&hi)[4] = acc[sl][2 * kk + 1];
            const unsigned ah[4] = {pack_bf16(fmaxf(lo[0], 0.0f), fmaxf(lo[1], 0.0f)),
                                    pack_bf16(fmaxf(lo[2], 0.0f), fmaxf(lo[3], 0.0f)),
                                    pack_bf16(fmaxf(hi[0], 0.0f), fmaxf(hi[1], 0.0f)),
                                    pack_bf16(fmaxf(hi[2], 0.0f), fmaxf(hi[3], 0.0f))};
#pragma unroll
            for (int jn = 0; jn < 4; ++jn)
              if (jn < ktiles) mma_bf16(logit[sl][jn], ah, bwf[jn]);
          }
        }
      };
      // the ring: slab j + stages - 1 is fetched once every thread is done
      // with slab j - 1, whose stage it takes; one barrier per slab
      if (tid == 0) {   // the stream's first slabs
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int j = 0; j < a.stages - 1 && j < J; ++j) fetch(j);
      }
#pragma unroll 1
      for (int j = 0; j < J; ++j) {
        const unsigned gj = ring_base + j;
        mbar_wait(mbar_u + 8 * (gj % a.stages), (gj / a.stages) & 1);
        if (j == 0) cp_async_wait(0);   // the pass's staged rows
        __syncthreads();
        if (tid == 0 && j + a.stages - 1 < J) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          fetch(j + a.stages - 1);
        }
        compute(j, ring + (gj % a.stages) * stage_bytes);
      }
      ring_base += J;

      // -- this pass's softmax partials of the group's joints, merged into part
      float mx[4][2];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) mx[jn][0] = mx[jn][1] = -INFINITY;
#pragma unroll
      for (int sl = 0; sl < kMT; ++sl) {
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int X = sxg[sl] * 16 + g + 8 * (e >> 1), j = kg * kJG + jn * 8 + 2 * t4 + (e & 1);
            float l = -INFINITY;
            if (sok[sl] && X < W0 && j < a.K) l = (logit[sl][jn][e] + a.b_final[j]) * temp;
            logit[sl][jn][e] = l;
            mx[jn][e & 1] = fmaxf(mx[jn][e & 1], l);
          }
      }
      float* rmax = red + kWarps * kJG * 3;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float v = mx[jn][u];
          for (int off = 4; off < 32; off *= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
          if (g == 0) red[warp * kJG + jn * 8 + 2 * t4 + u] = v;
        }
      __syncthreads();
      if (tid < kJG) {
        float v = red[tid];
        for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w * kJG + tid]);
        rmax[tid] = v;
      }
      __syncthreads();
      float sum[4][2][3];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int u = 0; u < 2; ++u) sum[jn][u][0] = sum[jn][u][1] = sum[jn][u][2] = 0.0f;
#pragma unroll
      for (int sl = 0; sl < kMT; ++sl) {
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l = logit[sl][jn][e];
            if (l == -INFINITY) continue;
            const float ex = expf(l - rmax[jn * 8 + 2 * t4 + (e & 1)]);
            sum[jn][e & 1][0] += ex;
            sum[jn][e & 1][1] += ex * (float)(sxg[sl] * 16 + g + 8 * (e >> 1));
            sum[jn][e & 1][2] += ex * (float)(yp + syr[sl]);
          }
      }
      __syncthreads();   // every warp has read rmax; red is rewritten below
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int f = 0; f < 3; ++f) {
            float v = sum[jn][u][f];
            for (int off = 4; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
            if (g == 0) red[(warp * kJG + jn * 8 + 2 * t4 + u) * 3 + f] = v;
          }
      __syncthreads();
      if (tid < kJG && kg * kJG + tid < a.K) {
        float s = 0.0f, su = 0.0f, sv = 0.0f;
        for (int w = 0; w < kWarps; ++w) {
          s += red[(w * kJG + tid) * 3 + 0];
          su += red[(w * kJG + tid) * 3 + 1];
          sv += red[(w * kJG + tid) * 3 + 2];
        }
        float4& p = reinterpret_cast<float4*>(part)[kg * kJG + tid];
        const float m = rmax[tid], M = fmaxf(p.x, m);
        const float fo = p.x == -INFINITY ? 0.0f : expf(p.x - M), fn = expf(m - M);
        p = make_float4(M, p.y * fo + s * fn, p.z * fo + su * fn, p.w * fo + sv * fn);
      }
      __syncthreads();   // the ring and red are free for the next group or pass
    }
  }

  // -- the cluster's bands combined through distributed shared memory
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int nb = (int)cluster.num_blocks();
    for (int j = tid; j < a.K; j += kThreads) {
      float M = -INFINITY;
      for (int r = 0; r < nb; ++r) M = fmaxf(M, cluster.map_shared_rank(part, r)[4 * j]);
      float s = 0.0f, su = 0.0f, sv = 0.0f;
      for (int r = 0; r < nb; ++r) {
        const float4 p = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r))[j];
        const float f = expf(p.x - M);
        s += p.y * f;
        su += p.z * f;
        sv += p.w * f;
      }
      a.out[((size_t)b * a.K + j) * 2 + 0] = su / s;
      a.out[((size_t)b * a.K + j) * 2 + 1] = sv / s;
    }
  }
  cluster.sync();   // no block leaves while rank 0 reads its shared memory
}

template <typename T, bool kWhole>
int launch_head(const HeadArgs& a, int B, cudaStream_t stream) {
  static int raised[kMaxDevices] = {};
  cudaError_t err = raise_smem(head_kernel<T, kWhole>, a.smem, raised);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.bands, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.bands;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, head_kernel<T, kWhole>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace hrnet

using namespace hrnet;

// The head in one launch with the plan of fused_head_decode.py::head_plan:
// `bands` blocks (a cluster) per sample of RB output rows each, passes of RP
// rows whose head tiles go to the warps in units of UR rows, at most SR_i
// source rows of branch i staged per pass, KW k16 steps of W-mix window,
// weight slabs of `slab_rows` rows in a ring of `stages`, `smem` bytes.
// w_i come in slab_layout (Np / 32, cp_i, 32), cp_i = C_i rounded up to 16
// and Np a multiple of 32, w_final (ceil(K / 32), Np / 32, 32, 32).  Slabs
// of whole branches select the instance whose branch GEMMs end within a
// slab.  A plan whose numbers do not add up returns cudaErrorInvalidValue;
// else the launch's error.
extern "C" int hrnet_head_fused(const void* x0, const void* x1, const void* x2, const void* x3,
                                const void* w0, const void* w1, const void* w2, const void* w3,
                                const void* b_head, const void* w_final, const void* b_final,
                                const void* temp, const void* taps, void* out, int B, int H0,
                                int W0, int C0, int h1, int ww1, int h2, int ww2, int h3, int ww3,
                                int C1, int C2, int C3, int Np, int K, int L, int in_int8,
                                int bands, int RB, int RP, int UR, int KW, int SR1, int SR2,
                                int SR3, int slab_rows, int stages, int smem, void* stream) {
  HeadArgs a{};
  const void* xs[4] = {x0, x1, x2, x3};
  const void* ws[4] = {w0, w1, w2, w3};
  const int hs[4] = {H0, h1, h2, h3}, wd[4] = {W0, ww1, ww2, ww3}, cs[4] = {C0, C1, C2, C3};
  const int srs[4] = {0, SR1, SR2, SR3};
  bool ok = B >= 1 && K >= 1 && K <= 4 * kJG && Np >= kNC && Np % kNC == 0 && bands >= 1 &&
            bands <= kMaxBands && RB >= 1 && (bands - 1) * RB < H0 && bands * RB >= H0 &&
            RP >= 1 && RP <= RB && (KW == 1 || KW == 2) && stages >= 2 && stages <= 6 &&
            slab_rows % 16 == 0 && L >= H0 && L >= W0;
  for (int i = 0; i < 4; ++i) {
    a.x[i] = xs[i];
    a.wt[i] = static_cast<const bf16*>(ws[i]);
    a.h[i] = hs[i];
    a.w[i] = wd[i];
    a.C[i] = cs[i];
    a.cp[i] = round16(cs[i]);
    a.SR[i] = srs[i];
    ok = ok && hs[i] >= 1 && wd[i] >= 1 && cs[i] >= 1;
    if (i) {
      // a branch's m16 tiles per pass: at most kUMax per warp, two warps per tile row
      ok = ok && hs[i] >= 2 && wd[i] >= 2 && srs[i] >= 2 && srs[i] <= hs[i] &&
           (srs[i] * wd[i] + 15) / 16 <= 2 * kUMax;
      a.S[i] = (a.cp[i] + slab_rows - 1) / slab_rows;
    }
  }
  a.b_head = static_cast<const float*>(b_head);
  a.w_final = static_cast<const bf16*>(w_final);
  a.b_final = static_cast<const float*>(b_final);
  a.temp = static_cast<const float*>(temp);
  a.taps = static_cast<const float*>(taps);
  a.out = static_cast<float*>(out);
  a.Np = Np;
  a.K = K;
  a.KG = (K + kJG - 1) / kJG;
  a.L = L;
  a.bands = bands;
  a.RB = RB;
  a.RP = RP;
  a.UR = UR;
  a.G = (W0 + 15) / 16;
  a.KW = KW;
  a.slab_rows = slab_rows;
  a.stages = stages;
  // the warps' head tiles: units of UR rows of one column group, 4 / UR units a warp
  const int units = a.G * ((RP + UR - 1) / UR);
  ok = ok && (UR == 1 || UR == 2 || UR == 4) && (units + kWarps - 1) / kWarps * UR <= kMT &&
       slab_rows >= a.cp[0] + kNC;
  if (!ok) return (int)cudaErrorInvalidValue;
  head_layout(a);
  if (a.smem != smem || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool whole = slab_rows >= a.cp[1] && slab_rows >= a.cp[2] && slab_rows >= a.cp[3];
  if (in_int8)
    return whole ? launch_head<signed char, true>(a, B, s)
                 : launch_head<signed char, false>(a, B, s);
  return whole ? launch_head<bf16, true>(a, B, s) : launch_head<bf16, false>(a, B, s);
}

// The head kernel's registers, local (spill) bytes and shared bytes per
// thread block as compiled, for reports: out[0..2]; `whole` selects the
// instance whose slabs hold whole branches.
extern "C" int hrnet_head_fused_attributes(int in_int8, int whole, void* out) {
  cudaFuncAttributes attr{};
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, in_int8 ? (whole ? head_kernel<signed char, true> : head_kernel<signed char, false>)
                     : (whole ? head_kernel<bf16, true> : head_kernel<bf16, false>));
  int* o = static_cast<int*>(out);
  o[0] = attr.numRegs;
  o[1] = (int)attr.localSizeBytes;
  o[2] = (int)attr.sharedSizeBytes;
  return (int)err;
}
