// Shared pieces of the port's int8 tensor-core kernels (int8_conv.cu,
// int8_res_block.cu, int8_gemm.cu): the fixed-point epilogue of
// yolo_tpu/quant/fixed_point.py and a two-stage shared-memory GEMM main
// loop on mma.sync m16n8k32 (s8 x s8 -> s32).
//
// Tiles: a block of 256 threads computes a BM = 128 row x BN column tile
// of C = A * B, A [rows, K] gathered by the caller, B [K, N] row-major
// (HWIO conv weights are [k*k*C_in, C_out] rows). K advances in BK = 64
// tiles; As[r][g] / Bs[n][g] pack the 4 int8 of depth 4g..4g+3 of row r /
// column n, so the mma fragments are single 32-bit shared-memory loads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 128;       // GEMM rows per block
constexpr int BK = 64;        // K depth per tile (int8 values)
constexpr int KG = BK / 4;    // packed int32 groups per tile row
constexpr int LDS = KG + 4;   // smem row stride (int32): conflict-free frags

// Multiply by 2^-s: fixed_point._shift, including shifts >= 32 (nearest ->
// 0, floor -> v >> 31) and negative (exact left) shifts.
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

__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);  // int32 adds wrap as XLA's do
}

// The requant chain after the accumulator shift. LeakyReLU is the Q16
// rational of fixed_point._leaky_int_slope: negatives become
// shift(v * slope_num, 16), slope_num = round(slope * 65536). 8192 is
// exactly the 0.125 arithmetic shift (v >> 3 with the same rounding) and
// 65536 the identity (no activation) for every int16 v, so one form serves
// every layer; with slope_num <= 65536 the product of an int16-clamped
// value stays in int32.
// One form also keeps the inlined epilogues small: a separate shift form
// made nvcc take four times as long over the conv sources.
struct Requant {
  int out_shift, slope_num, nearest;

  // v: the accumulator at the retune scale, bias already added
  __device__ __forceinline__ int8_t operator()(int v) const {
    const bool nr = nearest != 0;
    v = min(max(v, -32768), 32767);
    if (v < 0) v = shift_i32(v * slope_num, 16, nr);
    v = shift_i32(v, out_shift, nr);
    return (int8_t)min(max(v, -128), 127);
  }
};

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
  static constexpr int STAGE = (BM + BN) * LDS;  // int32 per smem stage
};

template <int BN>
using Acc = int[Tile<BN>::MF][Tile<BN>::NF][4];

template <int BN>
__device__ __forceinline__ void zero_acc(Acc<BN>& acc) {
#pragma unroll
  for (int i = 0; i < Tile<BN>::MF; ++i)
#pragma unroll
    for (int j = 0; j < Tile<BN>::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// acc += A[rows of this warp] x B[columns of this warp] over one K tile.
// Fragment layout of m16n8k32: a0/a2 row gid, a1/a3 row gid + 8, depth
// 4*tig (+16 for a2/a3); b0/b1 column gid, depth 4*tig (+16).
template <int BN>
__device__ __forceinline__ void warp_tile_mma(Acc<BN>& acc,
                                              const unsigned* As,
                                              const unsigned* Bs, int wm0,
                                              int wn0, int gid, int tig,
                                              int depth) {
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

// The B tile of a row-major [K, N] int8 matrix at columns n0..n0+BN:
// Bs[n][g] packs rows kt+4g..kt+4g+3 of column n0+n. With N % 4 == 0 (and
// a 4-byte aligned base) each thread reads 4x4-byte quads and transposes
// them in registers; otherwise byte by byte. Zero outside [K, N].
template <int BN>
struct BTile {
  static constexpr int QUADS = (BN / 4) * KG;  // 4x4-byte quads per tile
  static constexpr int Q_PER = (QUADS + THREADS - 1) / THREADS;
  static constexpr int E_PER = BN * KG / THREADS;  // packed words, bytes
  static constexpr int REGS = 4 * Q_PER > E_PER ? 4 * Q_PER : E_PER;

  const int8_t* w;
  int K, N, n0;
  bool vec;
  unsigned reg[REGS];

  __device__ __forceinline__ void load(int kt) {
    const int tid = threadIdx.x;
    if (vec) {
#pragma unroll
      for (int q = 0; q < Q_PER; ++q) {
        const int idx = tid + THREADS * q;
        const int c4 = idx % (BN / 4), g = idx / (BN / 4);
        const int co = n0 + 4 * c4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kt + 4 * g + j;
          reg[4 * q + j] = (idx < QUADS && co < N && k < K)
                               ? *reinterpret_cast<const unsigned*>(
                                     w + (long long)k * N + co)
                               : 0u;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < E_PER; ++q) {
        const int idx = tid + THREADS * q;
        const int n = idx % BN, g = idx / BN;
        const int co = n0 + n;
        unsigned packed = 0;
        if (co < N) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = kt + 4 * g + e;
            if (k < K)
              packed |= ((unsigned)(uint8_t)w[(long long)k * N + co])
                        << (8 * e);
          }
        }
        reg[q] = packed;
      }
    }
  }

  __device__ __forceinline__ void store(unsigned* Bs) const {
    const int tid = threadIdx.x;
    if (vec) {
#pragma unroll
      for (int q = 0; q < Q_PER; ++q) {
        const int idx = tid + THREADS * q;
        if (idx < QUADS) {
          const int c4 = idx % (BN / 4), g = idx / (BN / 4);
          // 4x4 byte transpose: rows k..k+3 of 4 columns -> 4 columns of
          // 4 consecutive k each
          const unsigned r0 = reg[4 * q], r1 = reg[4 * q + 1];
          const unsigned r2 = reg[4 * q + 2], r3 = reg[4 * q + 3];
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
      for (int q = 0; q < E_PER; ++q) {
        const int idx = tid + THREADS * q;
        Bs[(idx % BN) * LDS + idx / BN] = reg[q];
      }
    }
  }
};

// Two-stage main loop over K: thread t gathers row t/2 of the A tile, the
// 16 bytes [16*(t&1), +16) of each 32-deep half, with
// load_a(kt, areg[8]); stage kt/BK % 2 is multiplied while the next tile's
// global loads are in flight, then they land in the other stage. One
// barrier per K tile; on return every thread has passed the last barrier,
// so the caller may reuse the stages.
template <int BN, class LoadA>
__device__ __forceinline__ void gemm_mainloop(Acc<BN>& acc, unsigned* smem,
                                              int K, LoadA& load_a,
                                              BTile<BN>& bt, int wm0,
                                              int wn0) {
  constexpr int STAGE = Tile<BN>::STAGE;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int lr = tid >> 1, lh = tid & 1;
  unsigned areg[8];
  auto store_a = [&](unsigned* As) {
    *reinterpret_cast<uint4*>(&As[lr * LDS + 4 * lh]) =
        make_uint4(areg[0], areg[1], areg[2], areg[3]);
    *reinterpret_cast<uint4*>(&As[lr * LDS + 8 + 4 * lh]) =
        make_uint4(areg[4], areg[5], areg[6], areg[7]);
  };
  load_a(0, areg);
  bt.load(0);
  store_a(smem);
  bt.store(smem + BM * LDS);
  __syncthreads();
  for (int kt = 0, buf = 0; kt < K; kt += BK, buf ^= 1) {
    const bool more = kt + BK < K;
    if (more) {
      load_a(kt + BK, areg);
      bt.load(kt + BK);
    }
    const unsigned* cur = smem + buf * STAGE;
    warp_tile_mma<BN>(acc, cur, cur + BM * LDS, wm0, wn0, gid, tig, K - kt);
    if (more) {
      unsigned* nxt = smem + (buf ^ 1) * STAGE;
      store_a(nxt);
      bt.store(nxt + BM * LDS);
    }
    __syncthreads();
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

}  // namespace
