// Fused int8 conv3x3 (stride 1, pad 1) + fixed-point requant, for Hopper
// (sm_90a), with an optional 2x2/2 max pool, and its form on the padded
// space-to-depth input layout. Plain C interface, loaded with ctypes by
// yolo_tpu_torch/kernels/int8_conv.py.
//
// Replaces three Pallas TPU kernels of yolo_tpu/kernels/int8_conv.py:
//   K1 _conv_kernel        -> int8_conv3x3_requant       (conv kernel)
//   K2 _pool_matmul_kernel -> int8_conv3x3_pool_requant  (pool_s2d kernel;
//                             conv kernel with POOL for assembly='stride2')
//   K3 _im2col_kernel      -> int8_conv3x3_im2col        (conv kernel, POOL)
// On the TPU the three differ in how the matmul operands were assembled in
// VMEM (dy views + rolls, a 16*C_in phase-packed col, an in-VMEM im2col).
// Here they are two implicit GEMMs on the tensor cores:
//   conv:     rows = output pixels (with POOL the four conv pixels of each
//             pooled pixel are four consecutive rows), columns = C_out,
//             depth = 9*C_in in (dy, dx, ci) order = the HWIO weights.
//   pool_s2d: rows = pooled pixels, depth = the pixel's 4x4 input window,
//             which in the s2d layout is two contiguous runs of 8*C_in
//             bytes, columns = 4*C_out phase-packed weights (column
//             4*co + phase; built per block in shared memory), the pool
//             max taken over each column quad - the TPU kernel's
//             [16*C_in, 4*C_out] GEMM, without its col tensor in HBM.
//
// What bounds it on an H100: slim_yolo_v2 at 416^2 is ~2.52 GMAC/image, so
// a batch of 256 is ~1.29e12 int8 ops: ~0.65 ms at the data sheet's 1,979
// dense int8 TOPS, against ~0.8 GB of int8 activation traffic (~0.24 ms at
// 3.35 TB/s). The work is bound by operations, so the products run on the
// tensor cores (mma.sync m16n8k32 s8 -> s32). Each block computes a
// 128-row x BN-column tile (conv: BN = 16/32/64, matched to the columns so
// narrow layers waste none; pool_s2d: BN = 64/128); the A tile is gathered
// straight from the activation (16-byte loads when C_in % 16 == 0, else
// byte by byte; pool_s2d: 4-byte loads), the B tile is read from
// the HWIO weights and transposed 4x4 bytes in registers, and the next K
// tile's global loads are in flight while the current one is multiplied
// (two shared-memory stages, one barrier per K tile).
// The int32 accumulator, the pool max and the requant chain stay in
// registers; the int8 tile is staged in shared memory and written with
// 16-byte stores. Only int8 crosses device memory, and pooled layers never
// write their pre-pool activation. wgmma with TMA-fed multi-stage tiles is
// the next step toward the tensor-core bound.
//
// The requant epilogue mirrors yolo_tpu/quant/fixed_point.py::_shift
// exactly, including shifts >= 32 (nearest -> 0, floor -> v >> 31) and
// negative (exact left) shifts; int32 adds wrap as XLA's do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 128;       // GEMM rows per block
constexpr int BK = 64;        // K depth per tile (int8 values)
constexpr int KG = BK / 4;    // packed int32 groups per tile row
constexpr int LDS = KG + 4;   // smem row stride (int32): conflict-free frags

// A-tile gather modes of the conv kernel
constexpr int A_BYTE = 0;   // any C_in: one byte at a time
constexpr int A_VEC16 = 1;  // C_in % 16 == 0: 16-byte loads

__device__ __forceinline__ int shift_i32(int v, int s, bool nearest) {
  if (s == 0) return v;
  if (s < 0) {
    const int k = -s;
    return k >= 32 ? 0 : (int)((unsigned)v << k);
  }
  if (s >= 32) return nearest ? 0 : (v >> 31);
  if (!nearest) return v >> s;
  const unsigned off = 1u << (s - 1);
  return ((int)((unsigned)v + off - (unsigned)(v < 0))) >> s;
}

__device__ __forceinline__ int8_t requant(int acc, int bias_rt, int acc_shift,
                                          int out_shift, bool leaky,
                                          bool nearest) {
  int v = shift_i32(acc, acc_shift, nearest);
  v = (int)((unsigned)v + (unsigned)bias_rt);
  v = min(max(v, -32768), 32767);
  if (leaky && v < 0) v = shift_i32(v, 3, nearest);
  v = shift_i32(v, out_shift, nearest);
  v = min(max(v, -128), 127);
  return (int8_t)v;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
struct Tile {
  static constexpr int WN = BN < 32 ? BN : 32;  // warp tile columns
  static constexpr int WARPS_N = BN / WN;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int WM = BM / WARPS_M;  // warp tile rows
  static constexpr int MF = WM / 16;       // m16 fragments per warp
  static constexpr int NF = WN / 8;        // n8 fragments per warp
};

// acc += A[rows of this warp] x B[columns of this warp] over one K tile.
// As[r][g] / Bs[n][g] pack the 4 int8 of depth 4g..4g+3 of row r / column
// n. Fragment layout of m16n8k32: a0/a2 row gid, a1/a3 row gid + 8, depth
// 4*tig (+16 for a2/a3); b0/b1 column gid, depth 4*tig (+16).
template <int BN>
__device__ __forceinline__ void warp_tile_mma(
    int (&acc)[Tile<BN>::MF][Tile<BN>::NF][4], const unsigned* As,
    const unsigned* Bs, int wm0, int wn0, int gid, int tig, int depth) {
  using T = Tile<BN>;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (32 * ks < depth) {
      unsigned a[T::MF][4], bf[T::NF][2];
#pragma unroll
      for (int mf = 0; mf < T::MF; ++mf) {
        const int r = wm0 + 16 * mf + gid;
        a[mf][0] = As[r * LDS + 8 * ks + tig];
        a[mf][1] = As[(r + 8) * LDS + 8 * ks + tig];
        a[mf][2] = As[r * LDS + 8 * ks + 4 + tig];
        a[mf][3] = As[(r + 8) * LDS + 8 * ks + 4 + tig];
      }
#pragma unroll
      for (int nf = 0; nf < T::NF; ++nf) {
        const int n = wn0 + 8 * nf + gid;
        bf[nf][0] = Bs[n * LDS + 8 * ks + tig];
        bf[nf][1] = Bs[n * LDS + 8 * ks + 4 + tig];
      }
#pragma unroll
      for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < T::NF; ++nf)
          mma_s8(acc[mf][nf], a[mf], bf[nf][0], bf[nf][1]);
    }
  }
}

// Copy a staged int8 tile (orows_tile rows of `width` bytes) to out rows
// orow0.. at column col0, 16 bytes at a time where the layout allows.
__device__ __forceinline__ void store_tile(const int8_t* stage, int width,
                                           int orows_tile, int8_t* out,
                                           long long orow0, long long orows,
                                           int Cout, int col0, int ncols) {
  const int tid = threadIdx.x;
  if ((Cout & 15) == 0 && (ncols & 15) == 0 && (col0 & 15) == 0 &&
      (width & 15) == 0) {
    const int cpr = width / 16;  // 16-byte chunks per tile row
    for (int i = tid; i < orows_tile * cpr; i += THREADS) {
      const int ol = i / cpr, ch = i - ol * cpr;
      if (16 * ch < ncols && orow0 + ol < orows)
        *reinterpret_cast<uint4*>(out + (orow0 + ol) * Cout + col0 +
                                  16 * ch) =
            *reinterpret_cast<const uint4*>(stage + ol * width + 16 * ch);
    }
  } else {
    for (int i = tid; i < orows_tile * width; i += THREADS) {
      const int ol = i / width, cl = i - ol * width;
      if (cl < ncols && orow0 + ol < orows)
        out[(orow0 + ol) * Cout + col0 + cl] = stage[ol * width + cl];
    }
  }
}

// ---------------------------------------------------------------------------
// conv: NHWC input, [2x2 pool]
// ---------------------------------------------------------------------------

template <int BN, bool POOL, int AMODE>
__global__ void __launch_bounds__(THREADS)
conv3x3_requant_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const int* __restrict__ bias_rt,
                       int8_t* __restrict__ out, int B, int H, int W, int Cin,
                       int Cout, int acc_shift, int out_shift, int leaky,
                       int nearest) {
  using T = Tile<BN>;
  // Two stages of A and B tiles; after the K loop the same bytes stage the
  // int8 output tile (BM x BN <= (BM + BN) * LDS * 4 bytes for every BN)
  constexpr int STAGE = (BM + BN) * LDS;
  __shared__ __align__(16) unsigned smem[2 * STAGE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int Ho = POOL ? H / 2 : H, Wo = POOL ? W / 2 : W;
  const long long rows = (long long)B * Ho * Wo * (POOL ? 4 : 1);
  const long long row0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;

  // ---- this thread's A row: GEMM row row0 + lr; of each 32-deep half of
  // the K tile it gathers the 16 bytes at [16 * lh, 16 * lh + 16)
  const int lr = tid >> 1, lh = tid & 1;
  const long long grow = row0 + lr;
  const bool row_ok = grow < rows;
  int b = 0, oy = 0, ox = 0;
  if (row_ok) {
    // 32-bit division: the wrapper keeps B * H * W below 2^31
    unsigned p = (unsigned)grow;
    int ph = 0;
    if (POOL) {
      ph = (int)(p & 3);
      p >>= 2;
    }
    ox = (int)(p % (unsigned)Wo);
    p /= (unsigned)Wo;
    oy = (int)(p % (unsigned)Ho);
    b = (int)(p / (unsigned)Ho);
    if (POOL) {
      oy = 2 * oy + (ph >> 1);
      ox = 2 * ox + (ph & 1);
    }
  }
  // byte offset of channel c of tap `tap` of this row's pixel, or -1 in the
  // zero padding
  auto tap_offset = [&](int tap, int c) -> long long {
    const int y = oy + tap / 3 - 1, xx = ox + tap % 3 - 1;
    if (y < 0 || y >= H || xx < 0 || xx >= W) return -1;
    return (((long long)b * H + y) * W + xx) * Cin + c;
  };

  unsigned areg[8], breg[8];

  auto load_a = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 8; ++i) areg[i] = 0;
    if (!row_ok) return;
    if (AMODE == A_VEC16) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int k0 = kt + 32 * p + 16 * lh;
        if (k0 < K) {
          const int tap = k0 / Cin;
          const long long off = tap_offset(tap, k0 - tap * Cin);
          if (off >= 0) {
            const uint4 v = *reinterpret_cast<const uint4*>(x + off);
            areg[4 * p + 0] = v.x;
            areg[4 * p + 1] = v.y;
            areg[4 * p + 2] = v.z;
            areg[4 * p + 3] = v.w;
          }
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int k = kt + 32 * (e >> 4) + 16 * lh + (e & 15);
        if (k < K) {
          const int tap = k / Cin;
          const long long off = tap_offset(tap, k - tap * Cin);
          if (off >= 0)
            areg[e >> 2] |= ((unsigned)(uint8_t)x[off]) << (8 * (e & 3));
        }
      }
    }
  };

  auto store_a = [&](unsigned* As) {
    *reinterpret_cast<uint4*>(&As[lr * LDS + 4 * lh]) =
        make_uint4(areg[0], areg[1], areg[2], areg[3]);
    *reinterpret_cast<uint4*>(&As[lr * LDS + 8 + 4 * lh]) =
        make_uint4(areg[4], areg[5], areg[6], areg[7]);
  };

  // B tile: Bs[n][g] packs w[k][n0 + n] for k = kt + 4g .. kt + 4g + 3.
  const bool bvec = (Cout & 3) == 0;
  constexpr int BQ = (BN / 4) * KG;  // 4x4-byte quads per tile
  constexpr int BQ_PER = (BQ + THREADS - 1) / THREADS;
  constexpr int BE_PER = BN * KG / THREADS;  // int32 per thread, bytes

  auto load_b = [&](int kt) {
    if (bvec) {
#pragma unroll
      for (int q = 0; q < BQ_PER; ++q) {
        const int idx = tid + THREADS * q;
        const int c4 = idx % (BN / 4), g = idx / (BN / 4);
        const int co = n0 + 4 * c4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kt + 4 * g + j;
          breg[4 * q + j] = (idx < BQ && co < Cout && k < K)
                                ? *reinterpret_cast<const unsigned*>(
                                      w + (long long)k * Cout + co)
                                : 0u;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < BE_PER; ++q) {
        const int idx = tid + THREADS * q;
        const int n = idx % BN, g = idx / BN;
        const int co = n0 + n;
        unsigned packed = 0;
        if (co < Cout) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = kt + 4 * g + e;
            if (k < K)
              packed |= ((unsigned)(uint8_t)w[(long long)k * Cout + co])
                        << (8 * e);
          }
        }
        breg[q] = packed;
      }
    }
  };

  auto store_b = [&](unsigned* Bs) {
    if (bvec) {
#pragma unroll
      for (int q = 0; q < BQ_PER; ++q) {
        const int idx = tid + THREADS * q;
        if (idx < BQ) {
          const int c4 = idx % (BN / 4), g = idx / (BN / 4);
          // 4x4 byte transpose: rows k..k+3 of 4 columns -> 4 columns of
          // 4 consecutive k each
          const unsigned r0 = breg[4 * q], r1 = breg[4 * q + 1];
          const unsigned r2 = breg[4 * q + 2], r3 = breg[4 * q + 3];
          const unsigned t0 = __byte_perm(r0, r1, 0x5140);
          const unsigned t1 = __byte_perm(r0, r1, 0x7362);
          const unsigned t2 = __byte_perm(r2, r3, 0x5140);
          const unsigned t3 = __byte_perm(r2, r3, 0x7362);
          Bs[(4 * c4 + 0) * LDS + g] = __byte_perm(t0, t2, 0x5410);
          Bs[(4 * c4 + 1) * LDS + g] = __byte_perm(t0, t2, 0x7632);
          Bs[(4 * c4 + 2) * LDS + g] = __byte_perm(t1, t3, 0x5410);
          Bs[(4 * c4 + 3) * LDS + g] = __byte_perm(t1, t3, 0x7632);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < BE_PER; ++q) {
        const int idx = tid + THREADS * q;
        Bs[(idx % BN) * LDS + idx / BN] = breg[q];
      }
    }
  };

  const int wm0 = (warp / T::WARPS_N) * T::WM;
  const int wn0 = (warp % T::WARPS_N) * T::WN;
  int acc[T::MF][T::NF][4];
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int j = 0; j < T::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_a(0);
  load_b(0);
  store_a(smem);
  store_b(smem + BM * LDS);
  __syncthreads();

  // Stage kt/BK % 2 is multiplied while the next tile's global loads are in
  // flight and then land in the other stage; one barrier per K tile.
  for (int kt = 0, buf = 0; kt < K; kt += BK, buf ^= 1) {
    const bool more = kt + BK < K;
    if (more) {
      load_a(kt + BK);
      load_b(kt + BK);
    }
    const unsigned* cur = smem + buf * STAGE;
    warp_tile_mma<BN>(acc, cur, cur + BM * LDS, wm0, wn0, gid, tig, K - kt);
    if (more) {
      unsigned* nxt = smem + (buf ^ 1) * STAGE;
      store_a(nxt);
      store_b(nxt + BM * LDS);
    }
    __syncthreads();
  }

  // ---- epilogue: [pool max on int32] + requant into a staged int8 tile,
  // then 16-byte stores. Fragment layout: acc[.][.][0..1] at row gid,
  // columns 2*tig and 2*tig + 1; acc[.][.][2..3] at row gid + 8.
  const bool lk = leaky != 0, nr = nearest != 0;
  int8_t* stage = reinterpret_cast<int8_t*>(smem);
#pragma unroll
  for (int mf = 0; mf < T::MF; ++mf) {
#pragma unroll
    for (int nf = 0; nf < T::NF; ++nf) {
      int* c = acc[mf][nf];
      if (POOL) {
        // rows 4q..4q+3 (the phases of pooled pixel q) sit in lanes whose
        // gid differs in its two low bits; the requant chain is monotone,
        // so the max commutes with it exactly
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c[e] = max(c[e], __shfl_xor_sync(0xffffffffu, c[e], 4));
          c[e] = max(c[e], __shfl_xor_sync(0xffffffffu, c[e], 8));
        }
        if (gid & 3) continue;
      }
      const int cl = wn0 + 8 * nf + 2 * tig;
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int rl = wm0 + 16 * mf + gid + 8 * hrow;
        const int ol = POOL ? rl >> 2 : rl;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + cl + e;
          stage[ol * BN + cl + e] =
              co < Cout ? requant(c[2 * hrow + e], bias_rt[co], acc_shift,
                                  out_shift, lk, nr)
                        : (int8_t)0;
        }
      }
    }
  }
  __syncthreads();
  store_tile(stage, BN, POOL ? BM / 4 : BM, out, POOL ? row0 / 4 : row0,
             POOL ? rows / 4 : rows, Cout, n0, min(BN, Cout - n0));
}

// ---------------------------------------------------------------------------
// pool_s2d: the padded space-to-depth layout [B, H/2+3, W/2+3, 4*C_in], 2x2
// pool. Pooled pixel (u, v) reads blocks (u+1..u+2, v+1..v+2): two runs of
// 8*C_in contiguous bytes, in (block col s, py, px, c) order.
// ---------------------------------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(THREADS)
conv3x3_pool_s2d_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const int* __restrict__ bias_rt,
                        int8_t* __restrict__ out, int B, int H, int W, int Cin,
                        int Cout, int acc_shift, int out_shift, int leaky,
                        int nearest) {
  using T = Tile<BN>;
  __shared__ __align__(16) unsigned As[BM * LDS];
  __shared__ __align__(16) unsigned Bs[BN * LDS];
  __shared__ __align__(16) int8_t stage[BM * (BN / 4)];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int Ho = H / 2, Wo = W / 2, HB = Ho + 3, WB = Wo + 3;
  const int seg = 8 * Cin;  // bytes of one window row (two s2d blocks)
  const int K = 2 * seg;    // the 4x4 window: 16 * C_in
  const int N = 4 * Cout;   // column 4*co + phase
  const long long rows = (long long)B * Ho * Wo;
  const long long ntiles = (rows + BM - 1) / BM;
  const int n0 = blockIdx.y * BN;
  const int lr = tid >> 1, lh = tid & 1;
  const int wm0 = (warp / T::WARPS_N) * T::WM;
  const int wn0 = (warp % T::WARPS_N) * T::WN;
  const bool lk = leaky != 0, nr = nearest != 0;

  // Phase-packed weights: column 4*co + (a*2 + bb) at window depth
  // k = r*seg + s*4*C_in + (py*2 + px)*C_in + c holds w[j][kk][c][co] with
  // (j, kk) = (2r + py - a, 2s + px - bb) where that is a 3x3 tap, else 0
  // (the JAX package's _s2d_phase_weights, in this depth order).
  auto build_b = [&](int kt) {
    for (int idx = tid; idx < BN * KG; idx += THREADS) {
      const int n = idx % BN, g = idx / BN;
      const int col = n0 + n;
      unsigned packed = 0;
      if (col < N) {
        const int co = col >> 2, a = (col >> 1) & 1, bb = col & 1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kt + 4 * g + e;
          if (k < K) {
            const int r = k / seg, rem = k - r * seg;
            const int s = rem / (4 * Cin), rem2 = rem - s * 4 * Cin;
            const int pp = rem2 / Cin, c = rem2 - pp * Cin;
            const int j = 2 * r + (pp >> 1) - a, kk = 2 * s + (pp & 1) - bb;
            if (j >= 0 && j <= 2 && kk >= 0 && kk <= 2)
              packed |= ((unsigned)(uint8_t)w[((j * 3 + kk) * Cin + c) *
                                                  Cout + co])
                        << (8 * e);
          }
        }
      }
      Bs[n * LDS + g] = packed;
    }
  };
  const bool b_fixed = K <= BK;
  if (b_fixed) build_b(0);

  // persistent over row tiles: a fixed B tile is built once per block
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * BM;
    const long long grow = row0 + lr;
    const bool row_ok = grow < rows;
    long long base = 0;
    if (row_ok) {
      unsigned p = (unsigned)grow;  // B * H * W < 2^31 (wrapper)
      const int v = (int)(p % (unsigned)Wo);
      p /= (unsigned)Wo;
      const int u = (int)(p % (unsigned)Ho);
      const int b = (int)(p / (unsigned)Ho);
      base = (((long long)b * HB + u + 1) * WB + v + 1) * (4 * Cin);
    }
    int acc[T::MF][T::NF][4];
#pragma unroll
    for (int i = 0; i < T::MF; ++i)
#pragma unroll
      for (int j = 0; j < T::NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    for (int kt = 0; kt < K; kt += BK) {
      // A: int32 groups 4*lh .. 4*lh+3 and 8 + 4*lh .. 8 + 4*lh + 3
      unsigned areg[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int k = kt + 4 * ((q >> 2) * 8 + 4 * lh + (q & 3));
        unsigned v = 0;
        if (row_ok && k < K) {
          const int r = k / seg;
          v = *reinterpret_cast<const unsigned*>(
              x + base + (long long)r * WB * 4 * Cin + (k - r * seg));
        }
        areg[q] = v;
      }
      if (!b_fixed) build_b(kt);
      *reinterpret_cast<uint4*>(&As[lr * LDS + 4 * lh]) =
          make_uint4(areg[0], areg[1], areg[2], areg[3]);
      *reinterpret_cast<uint4*>(&As[lr * LDS + 8 + 4 * lh]) =
          make_uint4(areg[4], areg[5], areg[6], areg[7]);
      __syncthreads();
      warp_tile_mma<BN>(acc, As, Bs, wm0, wn0, gid, tig, K - kt);
      __syncthreads();
    }

    // epilogue: max over each column quad (the 4 pool phases of one
    // channel: 2 in this thread, 2 in lane ^ 1), requant, stage, store
#pragma unroll
    for (int mf = 0; mf < T::MF; ++mf) {
#pragma unroll
      for (int nf = 0; nf < T::NF; ++nf) {
        const int* c = acc[mf][nf];
        int v[2] = {max(c[0], c[1]), max(c[2], c[3])};
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow)
          v[hrow] = max(v[hrow], __shfl_xor_sync(0xffffffffu, v[hrow], 1));
        if (tig & 1) continue;
        const int cl = (wn0 + 8 * nf + 2 * tig) >> 2;  // local channel
        const int co = (n0 >> 2) + cl;
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow) {
          const int rl = wm0 + 16 * mf + gid + 8 * hrow;
          stage[rl * (BN / 4) + cl] =
              co < Cout ? requant(v[hrow], bias_rt[co], acc_shift, out_shift,
                                  lk, nr)
                        : (int8_t)0;
        }
      }
    }
    __syncthreads();
    store_tile(stage, BN / 4, BM, out, row0, rows, Cout, n0 >> 2,
               min(BN, N - n0) >> 2);
  }
}

template <int BN, bool POOL, int AMODE>
void launch_conv(const int8_t* x, const int8_t* w, const int* bias,
                 int8_t* out, int B, int H, int W, int Cin, int Cout,
                 int acc_shift, int out_shift, int leaky, int nearest,
                 cudaStream_t stream) {
  const long long rows = (long long)B * H * W;  // POOL: 4 rows per output
  dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  conv3x3_requant_kernel<BN, POOL, AMODE><<<grid, THREADS, 0, stream>>>(
      x, w, bias, out, B, H, W, Cin, Cout, acc_shift, out_shift, leaky,
      nearest);
}

template <int BN, bool POOL>
void dispatch_conv_a(const int8_t* x, const int8_t* w, const int* bias,
                     int8_t* out, int B, int H, int W, int Cin, int Cout,
                     int acc_shift, int out_shift, int leaky, int nearest,
                     cudaStream_t st) {
  if (Cin % 16 == 0)
    launch_conv<BN, POOL, A_VEC16>(x, w, bias, out, B, H, W, Cin, Cout,
                                   acc_shift, out_shift, leaky, nearest, st);
  else
    launch_conv<BN, POOL, A_BYTE>(x, w, bias, out, B, H, W, Cin, Cout,
                                  acc_shift, out_shift, leaky, nearest, st);
}

template <bool POOL>
void dispatch_conv(const int8_t* x, const int8_t* w, const int* bias,
                   int8_t* out, int B, int H, int W, int Cin, int Cout,
                   int acc_shift, int out_shift, int leaky, int nearest,
                   cudaStream_t st) {
  // 64 columns at most: a 128-wide tile needs so many registers that only
  // one block fits on an SM, and its load latency goes unhidden
  if (Cout <= 16)
    dispatch_conv_a<16, POOL>(x, w, bias, out, B, H, W, Cin, Cout, acc_shift,
                              out_shift, leaky, nearest, st);
  else if (Cout <= 32)
    dispatch_conv_a<32, POOL>(x, w, bias, out, B, H, W, Cin, Cout, acc_shift,
                              out_shift, leaky, nearest, st);
  else
    dispatch_conv_a<64, POOL>(x, w, bias, out, B, H, W, Cin, Cout, acc_shift,
                              out_shift, leaky, nearest, st);
}

template <int BN>
int launch_pool_s2d(const int8_t* x, const int8_t* w, const int* bias,
                    int8_t* out, int B, int H, int W, int Cin, int Cout,
                    int acc_shift, int out_shift, int leaky, int nearest,
                    cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = ((long long)B * (H / 2) * (W / 2) + BM - 1) / BM;
  const long long resident = 8LL * sms;  // row tiles in flight at once
  dim3 grid((unsigned)(ntiles < resident ? ntiles : resident),
            (unsigned)((4 * Cout + BN - 1) / BN));
  conv3x3_pool_s2d_kernel<BN><<<grid, THREADS, 0, stream>>>(
      x, w, bias, out, B, H, W, Cin, Cout, acc_shift, out_shift, leaky,
      nearest);
  return 0;
}

int dispatch_pool_s2d(const int8_t* x, const int8_t* w, const int* bias,
                      int8_t* out, int B, int H, int W, int Cin, int Cout,
                      int acc_shift, int out_shift, int leaky, int nearest,
                      cudaStream_t st) {
  if (4 * Cout <= 64)
    return launch_pool_s2d<64>(x, w, bias, out, B, H, W, Cin, Cout,
                               acc_shift, out_shift, leaky, nearest, st);
  return launch_pool_s2d<128>(x, w, bias, out, B, H, W, Cin, Cout, acc_shift,
                              out_shift, leaky, nearest, st);
}

}  // namespace

extern "C" {

// x: int8 NHWC [B, H, W, Cin], or with s2d the padded space-to-depth layout
// [B, H/2+3, W/2+3, 4*Cin] of an H x W image (s2d needs pool). w: int8 HWIO
// [3, 3, Cin, Cout]. bias_rt: int32 [Cout], already at the retune scale.
// out: int8 [B, H, W, Cout], or [B, H/2, W/2, Cout] with pool. H and W are
// even with pool or s2d. x is 4-byte aligned with s2d, else 16-byte aligned
// when C_in % 16 == 0; w is 4-byte aligned, out 16-byte aligned;
// B * H * W < 2^31. Returns cudaGetLastError() after the launch.
int yolo_int8_conv3x3_requant(const void* x, const void* w,
                              const void* bias_rt, void* out, int B, int H,
                              int W, int Cin, int Cout, int acc_shift,
                              int out_shift, int leaky, int nearest, int pool,
                              int s2d, void* stream) {
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const int* bi = static_cast<const int*>(bias_rt);
  int8_t* oi = static_cast<int8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s2d) {
    if (!pool) return (int)cudaErrorInvalidValue;
    const int rc = dispatch_pool_s2d(xi, wi, bi, oi, B, H, W, Cin, Cout,
                                     acc_shift, out_shift, leaky, nearest, st);
    if (rc != 0) return rc;
  } else if (pool) {
    dispatch_conv<true>(xi, wi, bi, oi, B, H, W, Cin, Cout, acc_shift,
                        out_shift, leaky, nearest, st);
  } else {
    dispatch_conv<false>(xi, wi, bi, oi, B, H, W, Cin, Cout, acc_shift,
                         out_shift, leaky, nearest, st);
  }
  return (int)cudaGetLastError();
}

const char* yolo_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
