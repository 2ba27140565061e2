// Pieces shared by the port's wgmma convolution kernels, the fused
// residual block (int8_res_block.cu, K4), the 3x3 conv
// (int8_conv3x3_wgmma.cu), the thin-input entry convs
// (int8_entry_conv.cu) and the 1x1 conv (int8_conv1x1_wgmma.cu): the
// requant epilogue with its shifts set up on
// the host (or, per column, from a shift table), the 64 x 64 staging tile of a consumer warpgroup, the RS
// wgmma of a 3x3 phase, the 16-byte cp.async, and the planners of a
// block's output tile and ring.
//
// Both kernels keep a TH x TW output tile plus the halo of their 3x3's
// input in shared memory (K4: y1; the conv: x; at stride 1 the tile and a
// one-pixel border, at stride 2 the (2TH + 1) x (2TW + 1) input pixels it
// reads), rows y1_stride(C) = C + 16 bytes apart so that the 8 rows of an
// ldmatrix fall in 8 different 16-byte bank groups, beside a ring of
// weight stages that TMA fills (int8_wgmma.cuh) and one staging tile per
// consumer warpgroup.

#pragma once

#include <algorithm>
#include <array>

#include "int8_wgmma.cuh"

namespace {

constexpr int MAX_STAGES = 8;
constexpr int STG_BYTES = 64 * 64;  // a warpgroup's staging tile
// the largest dynamic shared memory of a block (H100: 227 KB)
constexpr int MAX_SMEM = 232448;
// a block's share when n run on an SM: 1/n of the SM's 228 KB, 1 KB of
// it reserved per block
constexpr int sm_share(int n) { return n == 1 ? MAX_SMEM : 233472 / n - 1024; }
constexpr int HALF_SM_SMEM = sm_share(2);

// v * 2^-s as fixed_point._shift computes it (round half away or floor,
// s >= 32, s < 0 as an exact left shift), in one branch-free form set up
// on the host: ((v << l) + a + (v < 0 ? n : 0)) >> r, masked by m (the
// value of int8_common.cuh's shift_i32, without its branches on s and the
// rounding). With every shift of a launch in [0, 31] (l = 0, m = -1) the
// kernel's SHORT form drops the left shift and the mask: 4 instructions
// instead of 6. On an H100 the general form alone made the 208^2 stage
// ~15% and v3 serving ~2% slower (PERF.md, section 6).
struct Shift {
  int l, a, n, r, m;
  template <bool SHORT>
  __device__ __forceinline__ int apply(int v) const {
    const unsigned t = (unsigned)(n & (v >> 31));
    if constexpr (SHORT) return (int)((unsigned)v + (unsigned)a + t) >> r;
    return ((int)(((unsigned)v << l) + (unsigned)a + t) >> r) & m;
  }
};

Shift make_shift(int s, bool nearest) {
  if (s == 0) return Shift{0, 0, 0, 0, -1};
  if (s < 0) return -s >= 32 ? Shift{0, 0, 0, 0, 0} : Shift{-s, 0, 0, 0, -1};
  if (s >= 32) return nearest ? Shift{0, 0, 0, 0, 0} : Shift{0, 0, 0, 31, -1};
  return nearest ? Shift{0, 1 << (s - 1), -1, s, -1} : Shift{0, 0, 0, s, -1};
}

bool short_shift(int s) { return s >= 0 && s < 32; }

// The accumulator Shift of one output column, from its entry c of a
// per-column shift table (int8_conv.py's acc_shift_table: c in [-32, 32],
// the per-channel sw's _shift_arr semantics already mapped onto _shift's),
// as make_shift(c, nearest) makes it, built in the kernel per column pair:
// registers cannot hold the Shifts of a tile's columns. SHORT: every entry
// of the table in [0, 31] (no left shift, no mask).
template <bool SHORT>
__device__ __forceinline__ Shift column_shift(int c, bool nearest) {
  if constexpr (SHORT) {
    const int a = nearest ? (int)((1u << c) >> 1) : 0;
    return Shift{0, a, a != 0 ? -1 : 0, c, -1};
  }
  const int r = min(max(c, 0), 31);
  const int a = nearest ? (int)((1u << r) >> 1) : 0;
  const bool zero = c <= -32 || (nearest && c >= 32);
  return Shift{min(max(-c, 0), 31), a, a != 0 ? -1 : 0, r, zero ? 0 : -1};
}

// 1 where the int32 v lies outside int16 (a value the requant clamps:
// int8_forward_diagnostics counts them), else 0
__device__ __forceinline__ int out_of_int16(int v) {
  return (unsigned)v + 32768u > 65535u;
}

// The requant chain of fixed_point._requant from the raw accumulator:
// shift to the retune scale, add the bias (int32 adds wrap), clamp to
// int16, LeakyReLU as the Q16 rational (negatives -> shift(v * slope, 16);
// slope 65536 is the identity), shift to the output scale, clamp to int8
// (int8_common.cuh's Requant, with the shifts above).
struct Epi {
  Shift acc, out;
  int slope, rnd;  // rnd: 32767 (nearest, v < 0) or 0 (floor)
  // the chain up to the output shift, before the int8 clamp
  template <bool SHORT>
  __device__ __forceinline__ int unclamped(int v, int bias) const {
    v = (int)((unsigned)acc.apply<SHORT>(v) + (unsigned)bias);
    v = min(max(v, -32768), 32767);
    const int t = (v * slope + rnd) >> 16;
    return out.apply<SHORT>(v < 0 ? t : v);
  }
  template <bool SHORT>
  __device__ __forceinline__ int8_t apply(int v, int bias) const {
    return (int8_t)min(max(unclamped<SHORT>(v, bias), -128), 127);
  }
  // the chain with a column's own accumulator shift `sh` in place of
  // `acc` (a per-channel sw)
  template <bool SHORT>
  __device__ __forceinline__ int8_t apply(const Shift& sh, int v,
                                          int bias) const {
    return (int8_t)min(max(rest<SHORT>(sh.apply<SHORT>(v), bias), -128),
                       127);
  }
  // the chain after the accumulator shift, before the int8 clamp, from a
  // value already at the retune scale (the sum of a two-part conv's
  // partials, each shifted on its own)
  template <bool SHORT>
  __device__ __forceinline__ int rest(int v, int bias) const {
    v = (int)((unsigned)v + (unsigned)bias);
    v = min(max(v, -32768), 32767);
    const int t = (v * slope + rnd) >> 16;
    return out.apply<SHORT>(v < 0 ? t : v);
  }
};

// two unclamped values clamped to int8 and packed (lo in the low byte)
// by one instruction, cvt.pack.sat
__device__ __forceinline__ uint16_t pack_sat2(int lo, int hi) {
  unsigned d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(hi), "r"(lo), "r"(0));
  return (uint16_t)d;
}

Epi make_epi(int acc_shift, int out_shift, int slope_num, bool nearest) {
  return Epi{make_shift(acc_shift, nearest), make_shift(out_shift, nearest),
             slope_num, nearest ? 32767 : 0};
}

__host__ __device__ inline int y1_stride(int cmid) { return cmid + 16; }

// bytes of the halo tile of C channels that a th x tw output tile of a
// 3x3 of stride 1 or 2 reads, 128-byte aligned
__host__ __device__ inline int halo_bytes(int th, int tw, int c,
                                          int stride = 1) {
  return (((th - 1) * stride + 3) * ((tw - 1) * stride + 3) * y1_stride(c) +
          127) & ~127;
}

// staging byte of (row, column) of a 64 x 64 tile: 16-byte chunks XOR-ed
// with (row / 2) % 4, so the 2-byte stores of a warp hit 16 banks
__device__ __forceinline__ int stg_at(int row, int col) {
  return row * 64 + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

template <int N>
__device__ __forceinline__ void mma_rs(int (&d)[N / 2],
                                       const unsigned (&a)[4], uint64_t db) {
  if constexpr (N == 32) mma_rs_n32(d, a, db, 1);
  if constexpr (N == 64) mma_rs_n64(d, a, db, 1);
  if constexpr (N == 128) mma_rs_n128(d, a, db, 1);
}

// 16 bytes global -> shared, the first `bytes` (0 to 16) of them read, the
// rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one arrival on `bar` once every cp.async copy this thread has issued
// has landed (.noinc: the arrival is one of the phase's expected count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint16_t pack2(int8_t lo, int8_t hi) {
  return (uint16_t)((uint8_t)lo | ((uint16_t)(uint8_t)hi << 8));
}

// dynamic shared memory of a block: 1 KB of alignment slack, `stages`
// ring slots of `slot` bytes, the halo tile, `nwg` staging tiles and the
// ring's mbarriers
inline int block_smem(int tile_bytes, int slot, int nwg, int stages) {
  return 1024 + stages * slot + tile_bytes + nwg * STG_BYTES +
         2 * MAX_STAGES * 8;
}

struct TilePlan {
  int th, tw, stages, smem;  // smem 0: no tile fits
  int slab;  // channels of the halo tile: all C, or a slab of them
  int groups = 1;  // blocks per tile, each a share of the weight tiles
};

// A block's output tile and ring for an H x W image whose halo tile holds
// C channels (halo_bytes): the tile up to 26 x 26 pixels, its width and
// then its height halved until the halo tile fits beside a 3-stage ring of
// `slot`-byte stages in MAX_SMEM (at the darknet53 stages: 26 x 26 from
// 208^2 to 52^2, 26 x 13 at 26^2 C 256, 13 x 13 at 13^2 C 512, each
// keeping >= 85% of its 64-row wgmma steps on pixels); then the deepest
// ring that fits in `budget` bytes. With `even` (a pooled conv of an even
// image: whole 2x2 windows in every tile, edge tiles included) each
// halving rounds up to even, down to 2 (26 -> 14 -> 8 -> 4 -> 2), and the
// tile shrinks until its 3-stage block fits in `budget` itself, so that
// the form's blocks per SM do reside.
inline TilePlan plan_tile(int H, int W, int C, int slot, int nwg, int budget,
                          bool even = false) {
  const auto smem = [&](int th, int tw, int stages) {
    return block_smem(halo_bytes(th, tw, C), slot, nwg, stages);
  };
  const auto halve = [&](int t) {
    t = (t + 1) / 2;
    return even ? t + (t & 1) : t;
  };
  const int least = even ? 2 : 1, fit = even ? budget : MAX_SMEM;
  TilePlan p{std::min(26, H), std::min(26, W), 3, 0, C};
  while (smem(p.th, p.tw, 3) > fit && p.tw > least) p.tw = halve(p.tw);
  while (smem(p.th, p.tw, 3) > fit && p.th > least) p.th = halve(p.th);
  if (smem(p.th, p.tw, 3) > fit) return p;
  while (p.stages < MAX_STAGES && smem(p.th, p.tw, p.stages + 1) <= budget)
    ++p.stages;
  p.smem = smem(p.th, p.tw, p.stages);
  return p;
}

// The stride-2 3x3's output tile, halo slab and ring for an Ho x Wo output
// whose halo holds C channels, with `nn` weight tiles across C_out. A
// stride-2 halo holds ~4 input pixels per output pixel, so halving
// plan_tile's way leaves the deep layers thin tiles that fill few rows of
// an M step (52^2 C 256: 26 x 2). Instead every tile up to 26 x 26 whose
// block (halo + a 3-stage ring) fits in `budget` is weighed, its halo
// holding all C channels or, with `slabs` and where C is a multiple of 2
// or more of them, a slab of 256 or 128 (each slab's nine taps then run
// before the next slab is copied over it, for every M step and weight
// tile). The plan kept has the fewest M steps of nwg x 64 rows per image
// (each streams every weight and runs the whole K x N), then the fewest
// 64-row wgmma steps run (a warpgroup whose rows lie past an edge tile
// runs none), then the fewest halo bytes copied; then the deepest ring
// that fits in `budget`. At darknet53's five downsampling convs: 16 x 16
// tiles at 208^2 out, 9 x 21 at 104^2, 7 x 26 at 52^2, and 13 x 13 over
// slabs of 128 channels at 26^2 and 13^2, where on an H100 the slabs ran
// 16% and 45% faster than one halo of all channels (7 x 13 and 7 x 7
// tiles; PERF.md, section 6).
inline TilePlan plan_tile_s2(int Ho, int Wo, int C, int slot, int nwg,
                             int budget, int nn, bool slabs) {
  TilePlan best{0, 0, 3, 0, C};
  std::array<long long, 3> best_key{};
  for (const int slab : {C, 256, 128}) {
    if (slab != C && (!slabs || slab >= C || C % slab)) continue;
    const int loads = C / slab > 1 ? nn * (C / slab) : 1;  // per M step
    for (int th = 1; th <= std::min(26, Ho); ++th)
      for (int tw = 1; tw <= std::min(26, Wo); ++tw) {
        const int halo = halo_bytes(th, tw, slab, 2);
        if (block_smem(halo, slot, nwg, 3) > budget) continue;
        const int nc = (th * tw + 64 * nwg - 1) / (64 * nwg);
        const long long ntx = (Wo + tw - 1) / tw, nty = (Ho + th - 1) / th;
        // 64-row steps run by a column of tiles: nty - 1 full tiles and
        // one of the last rows
        const auto run = [&](int h) {
          return std::min(nc * nwg, (h * tw + 63) / 64);
        };
        const long long rows =
            (nty - 1) * run(th) + run(Ho - (int)(nty - 1) * th);
        const std::array<long long, 3> key{
            ntx * nty * nc, ntx * rows,
            ntx * nty * (C / slab > 1 ? nc : 1) * loads * (long long)halo};
        if (best.smem && !(key < best_key)) continue;
        best = TilePlan{th, tw, 3, block_smem(halo, slot, nwg, 3), slab};
        best_key = key;
      }
  }
  if (best.smem == 0) return best;
  const int halo = halo_bytes(best.th, best.tw, best.slab, 2);
  while (best.stages < MAX_STAGES &&
         block_smem(halo, slot, nwg, best.stages + 1) <= budget)
    ++best.stages;
  best.smem = block_smem(halo, slot, nwg, best.stages);
  return best;
}

// channels of a stride-1 halo slab (plan_tile_slabs)
constexpr int SLAB_C = 128;

// The stride-1 3x3's slab walk, for a B x H x W image of C channels with
// `nn` weight tiles across C_out, one block per SM: the halo tile holds a
// slab of SLAB_C channels in two buffers (one copied while the other is
// read), so the tile is plan_tile's halving over two slab halos, a whole
// 13 x 13 image at 13^2 (a halo of all 1,024 channels left 13 x 4), with
// the deepest ring that fits beside them and their two pairs of
// mbarriers (at most MAX_STAGES - 2 stages). Where the B x tiles blocks
// leave SMs of the `sms` idle, each tile's weight tiles are split over
// `groups` blocks (1, 2 or 4, at most nn): the fewest waves of blocks per
// unit of work, ceil(B tiles groups / sms) / groups, the fewer groups on
// a tie (batch 64 at 13^2: 2, batch 128: 1).
inline TilePlan plan_tile_slabs(int B, int H, int W, int C, int slot,
                                int nwg, int nn, int sms) {
  const auto smem = [&](int th, int tw, int stages) {
    return block_smem(2 * halo_bytes(th, tw, SLAB_C), slot, nwg, stages);
  };
  TilePlan p{std::min(26, H), std::min(26, W), 3, 0, SLAB_C};
  while (smem(p.th, p.tw, 3) > MAX_SMEM && p.tw > 1) p.tw = (p.tw + 1) / 2;
  while (smem(p.th, p.tw, 3) > MAX_SMEM && p.th > 1) p.th = (p.th + 1) / 2;
  if (smem(p.th, p.tw, 3) > MAX_SMEM || C % SLAB_C) return p;
  while (p.stages < MAX_STAGES - 2 &&
         smem(p.th, p.tw, p.stages + 1) <= MAX_SMEM)
    ++p.stages;
  p.smem = smem(p.th, p.tw, p.stages);
  const long long blocks = (long long)B * ((H + p.th - 1) / p.th) *
                           ((W + p.tw - 1) / p.tw);
  // waves per unit of work, compared as ceil(blocks g / sms) * 4 / g
  const auto cost = [&](int g) {
    return (blocks * g + sms - 1) / sms * (4 / g);
  };
  for (const int g : {2, 4})  // (no group without a weight tile)
    if ((g - 1) * ((nn + g - 1) / g) < nn && cost(g) < cost(p.groups))
      p.groups = g;
  return p;
}

}  // namespace
