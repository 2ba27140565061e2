// Fused darknet53 residual block, for Hopper (sm_90a): int8 [B, H, W, C]
// -> 1x1 conv + requant (C -> Cmid) -> 3x3 conv (stride 1, pad 1) + requant
// (Cmid -> C) -> [residual add with the input + requant] -> int8
// [B, H, W, C], in one kernel. Plain C interface, loaded with ctypes by
// yolo_tpu_torch/kernels/int8_conv.py (int8_res_block), which packs the
// weights K-major once per model (pack_res_block_weights): w1 as
// [Cmid, C], w2 as [C, 9 * Cmid] in (dy, dx, c) order (OHWI).
//
// Replaces the Pallas TPU kernel K4 _res_block_kernel / int8_res_block of
// yolo_tpu/kernels/int8_conv.py, and computes what the JAX package's chain
// int_conv_requant -> int_conv_requant(residual=...) computes, at either
// leaky slope: 0.125 (the shift, as the Pallas kernel) or a Q16 rational
// (0.1 in the darknet53 backbone of the v3 engine).
//
// What bounds it on an H100: a block at 416^2 is ~1.77 GOP per image
// (2 * H * W * 10 * C * Cmid) against 2 * H * W * C int8 bytes in and out,
// ~200-900 ops per byte, so it is bound by operations (1,979 dense int8
// TOPS) at every darknet53 stage but the first (208^2, C 64, bound by
// bytes) - if the mid activation y1 stays on chip. Each block owns a TH x
// TW output tile of one image (chosen per stage by plan() so that the
// 64-row wgmma steps carry pixels in >= 85% of their rows) and
//   1. computes y1 for the tile plus a one-pixel halo into shared memory:
//      a GEMM [halo pixels, C] x [C, Cmid] on wgmma (SS), whose A is a 4-D
//      TMA box of R1 halo rows x (TW + 2) pixels x 128 channels starting at
//      (ty0 - 1, tx0 - 1) (TMA zero-fills outside the image and past C);
//      y1 is zero outside the image (the 3x3 pads y1 with zeros, not with
//      requant(bias)). y1 rows are Cmid + 16 bytes apart, so the 8 rows of
//      an ldmatrix fall in 8 different 16-byte bank groups;
//   2. runs the 3x3 as an implicit GEMM [tile pixels, 9 * Cmid] x
//      [9 * Cmid, C] on wgmma (RS): each consumer warpgroup loads its A
//      fragments straight from y1 with ldmatrix (one 16-byte row address
//      per lane: the implicit-GEMM gather), taps outside and channels
//      inside, so the tap offsets are additions;
//   3. requantizes in registers (every shift one branch-free form set up
//      on the host), stages 64 x 64 bytes per warpgroup in shared memory
//      and stores 16 bytes at a time, adding the residual.
// The weights of both GEMMs stream through a shared-memory ring of 3-8
// stages that TMA fills (128-byte swizzle, full / empty mbarriers; one
// producer warp, or warpgroup whose registers go to the consumers). Three
// consumer warpgroups of 64 rows share each w2 tile (two, and two blocks
// per SM, in the narrow form of the 208^2 stage).
// Only x is read and only the block output written in device memory.
//
// The shifts follow yolo_tpu/quant/fixed_point.py::_shift, including
// s >= 32, which the Pallas kernel's _shift_round_nearest does not guard.
// A per-channel sw (quantize_pipeline_yolo_v3(per_channel=True) of the JAX
// package) runs the per-column form (Cols::column): each conv's
// accumulator shift per output column from an int32 table made on the
// host (int8_conv.py's acc_shift_table), an int2 of entries per column
// pair read through __ldg beside the bias at each use in both epilogues
// (column_shift of int8_wgmma_conv.cuh); sb, sa and retune stay scalars.

#include <type_traits>

#include "int8_wgmma_conv.cuh"

namespace {

template <int BN1, int BN2>
struct ResCfg {
  // consumer warpgroups, each owning 64 rows of a 3x3 M step: three for
  // the wide forms (a w2 tile feeds 192 rows), two for the narrow form so
  // two blocks fit on an SM at the byte-bound 208^2 stage
  static constexpr int NWG = BN2 == 64 ? 2 : 3;
  static constexpr int CONSUMERS = 128 * NWG;
  // + the producer: a whole warpgroup that hands its registers to the
  // consumers (setmaxnreg) in the wide forms, one warp in the narrow form
  static constexpr int THREADS = NWG == 3 ? 512 : CONSUMERS + 32;
  static constexpr int MIN_BLOCKS = BN2 == 64 ? 2 : 1;
  // a ring slot: phase 1 = x box (<= 128 rows) | w1 tile (BN1 rows);
  // phase 2 = two w2 tiles (BN2 rows each), one 256-deep K step
  static constexpr int B1_OFF = 128 * SW;
  static constexpr int SLOT = B1_OFF + BN1 * SW > 2 * BN2 * SW
                                  ? B1_OFF + BN1 * SW
                                  : 2 * BN2 * SW;
};

struct ResArgs {
  const int8_t* x;  // [B, H, W, C], for the residual
  const int* b1;    // [Cmid], at conv1's retune scale
  const int* b2;    // [C], at conv2's retune scale
  int8_t* out;      // [B, H, W, C]
  int B, H, W, C, Cmid;
  int TH, TW;    // output tile (the edge tiles may be smaller)
  int R1;        // halo rows per phase-1 TMA box, R1 * (TW + 2) <= 128
  int stages;    // ring depth, 3..MAX_STAGES
  Epi e1, e2;    // the two convs' requant chains
  int res;       // 1: residual add
  int sh_a, sh_b;  // residual: align conv2 out, align x
  Shift res_out;   // residual: the sum to 2^sa_res
};

// the accumulator shifts: one per conv (ResArgs' e1.acc, e2.acc), or per
// output column from a table per conv (a per-channel sw)
enum class Cols { scalar, column };

// the per-column form's arguments: each conv's accumulator shift table,
// conv1's [Cmid] and conv2's [C] (padded, 0 past the channels; e1.acc and
// e2.acc unused). Apart from ResArgs, whose scalar SASS a larger struct
// could move (int8_entry_conv.cu's ColsArgs).
struct ResColsArgs : ResArgs {
  const int* shifts1;
  const int* shifts2;
};

template <Cols C>
using ResArgsOf = std::conditional_t<C == Cols::scalar, ResArgs, ResColsArgs>;

template <int N>
__device__ __forceinline__ void mma_ss(int (&d)[N / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (N == 32) mma_ss_n32(d, da, db, 1);
  if constexpr (N == 64) mma_ss_n64(d, da, db, 1);
  if constexpr (N == 128) mma_ss_n128(d, da, db, 1);
}

template <int BN1, int BN2, bool SHORT, Cols CF = Cols::scalar>
__global__ void __launch_bounds__(ResCfg<BN1, BN2>::THREADS,
                                  ResCfg<BN1, BN2>::MIN_BLOCKS)
res_block_wgmma(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_w1,
                const __grid_constant__ CUtensorMap tm_w2,
                ResArgsOf<CF> a) {
  using Cfg = ResCfg<BN1, BN2>;
  constexpr int NWG = Cfg::NWG, CONSUMERS = Cfg::CONSUMERS;
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dsmem) + 1023) & ~uintptr_t(1023));
  const int HW = a.TW + 2, HH = a.TH + 2, S1 = y1_stride(a.Cmid);
  int8_t* y1 = reinterpret_cast<int8_t*>(smem + a.stages * Cfg::SLOT);
  int8_t* stg_all = y1 + halo_bytes(a.TH, a.TW, a.Cmid);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stg_all + NWG * STG_BYTES);
  const Ring ring{bars, bars + a.stages, a.stages};
  const int tid = threadIdx.x;

  // ---- this block's tile
  const int ntx = (a.W + a.TW - 1) / a.TW, nty = (a.H + a.TH - 1) / a.TH;
  const int b = blockIdx.x / (ntx * nty);
  const int t = blockIdx.x - b * ntx * nty;
  const int ty0 = (t / ntx) * a.TH, tx0 = (t % ntx) * a.TW;
  const int th = min(a.TH, a.H - ty0), tw = min(a.TW, a.W - tx0);

  // ---- the producer's and the consumers' common walk over the ring
  const int nc1 = (HH + a.R1 - 1) / a.R1;  // phase-1 boxes (M chunks)
  const int nn1 = a.Cmid / BN1, nk1 = (a.C + SW - 1) / SW;
  const int K2 = 9 * a.Cmid, nk2 = (K2 + 2 * SW - 1) / (2 * SW);
  const int nn2 = a.C / BN2, nc2 = (a.TH * a.TW + 64 * NWG - 1) / (64 * NWG);

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    if constexpr (NWG == 3)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS) {
      tma_prefetch_map(&tm_x);
      tma_prefetch_map(&tm_w1);
      tma_prefetch_map(&tm_w2);
      int i = 0;
      const unsigned x_bytes = a.R1 * HW * SW;
      for (int c = 0; c < nc1; ++c)
        for (int n = 0; n < nn1; ++n)
          for (int k = 0; k < nk1; ++k, ++i) {
            ring.producer_acquire(i, x_bytes + BN1 * SW);
            unsigned char* st = smem + ring.stage(i) * Cfg::SLOT;
            uint64_t* full = &ring.full[ring.stage(i)];
            tma_load_4d(st, &tm_x, full, k * SW, tx0 - 1, ty0 - 1 + c * a.R1,
                        b);
            tma_load_2d(st + Cfg::B1_OFF, &tm_w1, full, k * SW, n * BN1);
          }
      for (int c = 0; c < nc2; ++c)
        for (int n = 0; n < nn2; ++n)
          for (int k = 0; k < nk2; ++k, ++i) {
            const bool two = k * 2 * SW + SW < K2;
            ring.producer_acquire(i, (two ? 2 : 1) * BN2 * SW);
            unsigned char* st = smem + ring.stage(i) * Cfg::SLOT;
            uint64_t* full = &ring.full[ring.stage(i)];
            tma_load_2d(st, &tm_w2, full, k * 2 * SW, n * BN2);
            if (two)
              tma_load_2d(st + BN2 * SW, &tm_w2, full, k * 2 * SW + SW,
                          n * BN2);
          }
    }
    return;
  }

  // 3 x 128 x 152 + 128 x 40 of the SM's 65,536 registers
  if constexpr (NWG == 3)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, ltid = tid & 127;
  const long long img = (long long)b * a.H * a.W;  // first pixel of image b
  int i = 0;

  // ---- 1. y1 = requant(x[halo] * w1), zero outside the image
  for (int c = 0; c < nc1; ++c) {
    // halo pixels of this box that belong to the tile's halo
    const int valid = min(a.R1, HH - c * a.R1) * HW;
    const bool active = wg * 64 < valid;
    // this thread's two accumulator rows: halo pixel, inside the image
    int p[2];
    bool in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + warp * 16 + gid + 8 * h;
      p[h] = r < valid ? c * a.R1 * HW + r : -1;
      const int hy = p[h] / HW, hx = p[h] - hy * HW;
      const int gy = ty0 - 1 + hy, gx = tx0 - 1 + hx;
      in[h] = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    }
    for (int n = 0; n < nn1; ++n) {
      int acc[BN1 / 2];
#pragma unroll
      for (int e = 0; e < BN1 / 2; ++e) acc[e] = 0;
      for (int k = 0; k < nk1; ++k, ++i) {
        ring.consumer_wait(i);
        if (active) {
          const unsigned char* st = smem + ring.stage(i) * Cfg::SLOT;
          const uint64_t da = desc_sw128(st + wg * 64 * SW);
          const uint64_t db = desc_sw128(st + Cfg::B1_OFF);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < SW / 32; ++kk)
            mma_ss<BN1>(acc, da + 2 * kk, db + 2 * kk);
          wgmma_commit();
          wgmma_wait<0>();
        }
        ring.consumer_release(i);
      }
      if (!active) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (p[h] < 0) continue;
        int8_t* dst = y1 + p[h] * S1 + n * BN1 + 2 * tig;
#pragma unroll
        for (int j = 0; j < BN1 / 8; ++j) {
          const int co = n * BN1 + 8 * j + 2 * tig;
          const int2 bias = *reinterpret_cast<const int2*>(a.b1 + co);
          int8_t v0, v1;
          if constexpr (CF == Cols::scalar) {
            v0 = a.e1.apply<SHORT>(acc[4 * j + 2 * h], bias.x);
            v1 = a.e1.apply<SHORT>(acc[4 * j + 2 * h + 1], bias.y);
          } else {
            const bool nearest = a.e1.rnd != 0;
            const int2 sc =
                __ldg(reinterpret_cast<const int2*>(a.shifts1 + co));
            v0 = a.e1.apply<SHORT>(column_shift<SHORT>(sc.x, nearest),
                                   acc[4 * j + 2 * h], bias.x);
            v1 = a.e1.apply<SHORT>(column_shift<SHORT>(sc.y, nearest),
                                   acc[4 * j + 2 * h + 1], bias.y);
          }
          *reinterpret_cast<uint16_t*>(dst + 8 * j) =
              in[h] ? pack2(v0, v1) : (uint16_t)0;
        }
      }
    }
  }
  named_sync(1, CONSUMERS);  // y1 complete

  // ---- 2. the 3x3 over y1, 3. requant + residual
  const int P2 = a.TH * a.TW;     // rows of the nominal tile
  const int P2_live = th * a.TW;  // rows from here on lie below the image
  int8_t* stg = stg_all + wg * STG_BYTES;
  for (int c = 0; c < nc2; ++c) {
    const int p0 = (c * NWG + wg) * 64;
    const bool active = p0 < P2_live;
    // this lane's ldmatrix row: output pixel r of the tile
    int r = p0 + warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    if (r >= P2) r = 0;
    const int py = r / a.TW, px = r - py * a.TW;
    const int8_t* arow = y1 + (py * HW + px) * S1 + 16 * (lane >> 4);
    // the two 16-byte chunks this thread copies out: output byte offset of
    // their pixel, or -1 outside the image
    long long obase[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int po = p0 + ((ltid + 128 * q) >> 2);
      const int oy = po / a.TW, ox = po - oy * a.TW;
      obase[q] = oy < th && ox < tw
                     ? (img + (long long)(ty0 + oy) * a.W + tx0 + ox) * a.C
                     : -1;
    }
    for (int n = 0; n < nn2; ++n) {
      int acc[BN2 / 2];
#pragma unroll
      for (int e = 0; e < BN2 / 2; ++e) acc[e] = 0;
      // (tap, channel) of the next 32-deep K step: y1 offset tap_off +
      // ch, tap_off = (dy * HW + dx) * S1
      int tap_off = 0, ch = 0, dx = 0;
      for (int k = 0; k < nk2; ++k, ++i) {
        ring.consumer_wait(i);
        if (active) {
          const unsigned char* st = smem + ring.stage(i) * Cfg::SLOT;
          const uint64_t db = desc_sw128(st);
          // the step's two 128-deep halves (one w2 tile each), four
          // 32-deep A fragments in registers at a time
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (half == 1) wgmma_wait<0>();  // the first half's A retired
            unsigned af[SW / 32][4];
#pragma unroll
            for (int j = 0; j < SW / 32; ++j) {
              if (k * 2 * SW + half * SW + 32 * j < K2) {
                ldmatrix_x4(af[j], arow + tap_off + ch);
                ch += 32;
                if (ch == a.Cmid) {
                  ch = 0;
                  if (++dx == 3) {
                    dx = 0;
                    tap_off += (HW - 2) * S1;
                  } else {
                    tap_off += S1;
                  }
                }
              }
            }
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < SW / 32; ++j)
              if (k * 2 * SW + half * SW + 32 * j < K2)
                mma_rs<BN2>(acc, af[j],
                            db + ((half * BN2 * SW + j * 32) >> 4));
            wgmma_commit();
          }
          wgmma_wait<0>();
        }
        ring.consumer_release(i);
      }
      if (!active) continue;
      // 64 columns at a time through the warpgroup's staging tile
#pragma unroll
      for (int pass = 0; pass < BN2 / 64; ++pass) {
        const int col0 = n * BN2 + pass * 64;
        // the residual's x, loaded while the requant below runs (the
        // per-column form: halfway through it, below)
        uint4 xv[2];
        if constexpr (CF == Cols::scalar) {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (a.res && obase[q] >= 0)
              xv[q] = *reinterpret_cast<const uint4*>(a.x + obase[q] + col0 +
                                                      16 * (ltid & 3));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cl = 8 * j + 2 * tig;
          const int2 bias = *reinterpret_cast<const int2*>(a.b2 + col0 + cl);
          if constexpr (CF == Cols::scalar) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int* v = &acc[4 * (8 * pass + j) + 2 * h];
              *reinterpret_cast<uint16_t*>(
                  stg + stg_at(warp * 16 + gid + 8 * h, cl)) =
                  pack2(a.e2.apply<SHORT>(v[0], bias.x),
                        a.e2.apply<SHORT>(v[1], bias.y));
            }
          } else {
            // x once half the pass's accumulators are stored: loaded
            // beside the first column pairs' tables, it spilled the wide
            // forms' general shift form and the narrow short form (8
            // bytes each, on an H100)
            if (j == 4) {
#pragma unroll
              for (int q = 0; q < 2; ++q)
                if (a.res && obase[q] >= 0)
                  xv[q] = *reinterpret_cast<const uint4*>(
                      a.x + obase[q] + col0 + 16 * (ltid & 3));
            }
            // this column pair's Shifts, built here at each use: held in
            // registers beside the bias they could spill
            const bool nearest = a.e2.rnd != 0;
            const int2 sc =
                __ldg(reinterpret_cast<const int2*>(a.shifts2 + col0 + cl));
            const Shift s0 = column_shift<SHORT>(sc.x, nearest);
            const Shift s1 = column_shift<SHORT>(sc.y, nearest);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int* v = &acc[4 * (8 * pass + j) + 2 * h];
              *reinterpret_cast<uint16_t*>(
                  stg + stg_at(warp * 16 + gid + 8 * h, cl)) =
                  pack2(a.e2.apply<SHORT>(s0, v[0], bias.x),
                        a.e2.apply<SHORT>(s1, v[1], bias.y));
            }
          }
        }
        named_sync(2 + wg, 128);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (obase[q] < 0) continue;
          const int rl = (ltid + 128 * q) >> 2, c16 = ltid & 3;
          uint4 o = *reinterpret_cast<const uint4*>(stg + stg_at(rl, 16 * c16));
          if (a.res) {
            int8_t* ob = reinterpret_cast<int8_t*>(&o);
            const int8_t* xb = reinterpret_cast<const int8_t*>(&xv[q]);
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              const unsigned va = (unsigned)(int)ob[e] << a.sh_a;
              const unsigned vb = (unsigned)(int)xb[e] << a.sh_b;
              const int s = a.res_out.apply<SHORT>((int)(va + vb));
              ob[e] = (int8_t)min(max(s, -128), 127);
            }
          }
          *reinterpret_cast<uint4*>(a.out + obase[q] + col0 + 16 * c16) = o;
        }
        named_sync(2 + wg, 128);
      }
    }
  }
}

// The (BN1, BN2) form for Cmid, C: the widest of the three built.
int pick_form(int C, int Cmid) {
  if (Cmid % 128 == 0 && C % 128 == 0) return 2;
  if (Cmid % 64 == 0 && C % 128 == 0) return 1;
  return 0;
}

// an output tile and its halo rows per phase-1 box, R1 * (tw + 2) <= 128
void set_tile(ResArgs& a, int th, int tw) {
  a.TH = th;
  a.TW = tw;
  a.R1 = std::min(128 / (tw + 2), th + 2);
}

// The form's layout for an H x W stage, set in `a`: the output tile and
// ring of plan_tile (int8_wgmma_conv.cuh) for y1's Cmid channels, the ring
// in half an SM's shared memory for the two-block form. Returns the
// dynamic shared memory bytes, or 0 where no tile fits.
template <int BN1, int BN2>
int plan(ResArgs& a) {
  using Cfg = ResCfg<BN1, BN2>;
  const TilePlan p =
      plan_tile(a.H, a.W, a.Cmid, Cfg::SLOT, Cfg::NWG,
                Cfg::MIN_BLOCKS == 2 ? HALF_SM_SMEM : MAX_SMEM);
  if (p.smem == 0) return 0;
  set_tile(a, p.th, p.tw);
  a.stages = p.stages;
  return p.smem;
}

// Launches the form, or with `info` reports its layout there instead.
template <int BN1, int BN2, bool SHORT, Cols CF = Cols::scalar>
int launch_form(ResArgsOf<CF> a, const void* w1p, const void* w2p, int* info,
                cudaStream_t st) {
  using Cfg = ResCfg<BN1, BN2>;
  const int smem = plan<BN1, BN2>(a);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      res_block_wgmma<BN1, BN2, SHORT, CF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, res_block_wgmma<BN1, BN2, SHORT, CF>, Cfg::THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    const int vals[9] = {a.TH, a.TW,     a.R1,     smem,    blocks,
                         BN1,  BN2,      Cfg::NWG, a.stages};
    for (int k = 0; k < 9; ++k) info[k] = vals[k];
    return 0;
  }
  CUtensorMap tm_x, tm_w1, tm_w2;
  const cuuint64_t C = a.C, Cm = a.Cmid;
  const cuuint64_t dims_x[4] = {C, (cuuint64_t)a.W, (cuuint64_t)a.H,
                                (cuuint64_t)a.B};
  const cuuint64_t str_x[3] = {C, C * a.W, C * a.W * a.H};
  const cuuint32_t box_x[4] = {SW, (cuuint32_t)(a.TW + 2), (cuuint32_t)a.R1,
                               1};
  const cuuint64_t dims_1[2] = {C, Cm}, str_1[1] = {C};
  const cuuint32_t box_1[2] = {SW, BN1};
  const cuuint64_t dims_2[2] = {9 * Cm, C}, str_2[1] = {9 * Cm};
  const cuuint32_t box_2[2] = {SW, BN2};
  int rc = make_map(&tm_x, a.x, 4, dims_x, str_x, box_x);
  if (rc == 0) rc = make_map(&tm_w1, w1p, 2, dims_1, str_1, box_1);
  if (rc == 0) rc = make_map(&tm_w2, w2p, 2, dims_2, str_2, box_2);
  if (rc != 0) return rc;
  const long long ntiles = (long long)((a.H + a.TH - 1) / a.TH) *
                           ((a.W + a.TW - 1) / a.TW);
  res_block_wgmma<BN1, BN2, SHORT, CF>
      <<<(unsigned)(a.B * ntiles), Cfg::THREADS, smem, st>>>(tm_x, tm_w1,
                                                             tm_w2, a);
  return (int)cudaGetLastError();
}

template <bool SHORT, Cols CF = Cols::scalar>
int dispatch(const ResArgsOf<CF>& a, const void* w1p, const void* w2p,
             int* info, cudaStream_t st) {
  switch (pick_form(a.C, a.Cmid)) {
    case 2:
      return launch_form<128, 128, SHORT, CF>(a, w1p, w2p, info, st);
    case 1:
      return launch_form<64, 128, SHORT, CF>(a, w1p, w2p, info, st);
    default:
      return launch_form<32, 64, SHORT, CF>(a, w1p, w2p, info, st);
  }
}

bool bad_shape(int H, int W, int C, int Cmid) {
  return H < 1 || W < 1 || C < 64 || C % 64 || Cmid < 32 || Cmid % 32;
}

ResArgs base_args(int H, int W, int C, int Cmid) {
  ResArgs a{};
  a.H = H;
  a.W = W;
  a.C = C;
  a.Cmid = Cmid;
  return a;
}

// The operands and the residual's shifts, the same in both forms.
void set_operands(ResArgs& a, const void* x, const void* b1_rt,
                  const void* b2_rt, void* out, int B, int res, int sh_a,
                  int sh_b, int sh_out, bool nearest) {
  a.x = static_cast<const int8_t*>(x);
  a.b1 = static_cast<const int*>(b1_rt);
  a.b2 = static_cast<const int*>(b2_rt);
  a.out = static_cast<int8_t*>(out);
  a.B = B;
  a.res = res;
  a.sh_a = sh_a;
  a.sh_b = sh_b;
  a.res_out = make_shift(sh_out, nearest);
}

}  // namespace

extern "C" {

// x: int8 NHWC [B, H, W, C], C % 64 == 0; w1p: int8 [Cmid, C] (Cmid % 32
// == 0), w2p: int8 [C, 9 * Cmid] in (dy, dx, c) order; b1_rt / b2_rt:
// int32 at the two retune scales; out: int8 [B, H, W, C]; x, w1p, w2p and
// out 16-byte aligned. The kernel picks its output tile (plan; reported by
// yolo_int8_res_block_info) and fails where no tile fits.
// slope_num: the LeakyReLU slope of both convs * 65536 (8192: 0.125;
// 65536: none).
// res: add the residual: out = clamp(shift((o << sh_a) + (x << sh_b),
// sh_out)). Returns the first CUDA error of setting up or launching.
int yolo_int8_res_block(const void* x, const void* w1p, const void* b1_rt,
                        const void* w2p, const void* b2_rt, void* out, int B,
                        int H, int W, int C, int Cmid, int acc1, int out1,
                        int acc2, int out2, int slope_num, int nearest,
                        int res, int sh_a, int sh_b, int sh_out,
                        void* stream) {
  if (bad_shape(H, W, C, Cmid) || B < 1) return (int)cudaErrorInvalidValue;
  ResArgs a = base_args(H, W, C, Cmid);
  set_operands(a, x, b1_rt, b2_rt, out, B, res, sh_a, sh_b, sh_out,
               nearest != 0);
  a.e1 = make_epi(acc1, out1, slope_num, nearest != 0);
  a.e2 = make_epi(acc2, out2, slope_num, nearest != 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (short_shift(acc1) && short_shift(out1) && short_shift(acc2) &&
      short_shift(out2) && short_shift(sh_out))
    return dispatch<true>(a, w1p, w2p, nullptr, st);
  return dispatch<false>(a, w1p, w2p, nullptr, st);
}

// The per-column form (a per-channel sw): as yolo_int8_res_block, with
// each column's accumulator shift from a table (int32, each column's shift
// as _shift reads it, int8_conv.py's acc_shift_table, 0 past the
// channels, 8-byte aligned) in place of acc1 / acc2: shifts1 conv1's
// [>= Cmid], shifts2 conv2's [>= C]; short_cols: every entry of both in
// [0, 31]. The short shift form where those, out1, out2 and sh_out are
// short. Its layout is the scalar form's (yolo_int8_res_block_info).
int yolo_int8_res_block_cols_wgmma(const void* x, const void* w1p,
                                   const void* b1_rt, const void* shifts1,
                                   const void* w2p, const void* b2_rt,
                                   const void* shifts2, void* out, int B,
                                   int H, int W, int C, int Cmid, int out1,
                                   int out2, int short_cols, int slope_num,
                                   int nearest, int res, int sh_a, int sh_b,
                                   int sh_out, void* stream) {
  if (bad_shape(H, W, C, Cmid) || B < 1 || shifts1 == nullptr ||
      shifts2 == nullptr)
    return (int)cudaErrorInvalidValue;
  ResColsArgs a{};
  static_cast<ResArgs&>(a) = base_args(H, W, C, Cmid);
  set_operands(a, x, b1_rt, b2_rt, out, B, res, sh_a, sh_b, sh_out,
               nearest != 0);
  a.e1 = make_epi(0, out1, slope_num, nearest != 0);
  a.e2 = make_epi(0, out2, slope_num, nearest != 0);
  a.shifts1 = static_cast<const int*>(shifts1);
  a.shifts2 = static_cast<const int*>(shifts2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (short_cols && short_shift(out1) && short_shift(out2) &&
      short_shift(sh_out))
    return dispatch<true, Cols::column>(a, w1p, w2p, nullptr, st);
  return dispatch<false, Cols::column>(a, w1p, w2p, nullptr, st);
}

// The kernel's layout at an H x W x C stage with Cmid mid channels:
// info[0..8] = tile height, tile width, halo rows per phase-1 box (R1),
// dynamic shared memory bytes, resident blocks per SM, BN1, BN2, consumer
// warpgroups, ring stages. Returns 0, or an error code where the shape is
// not taken or no tile fits in shared memory.
int yolo_int8_res_block_info(int H, int W, int C, int Cmid, int* info) {
  if (bad_shape(H, W, C, Cmid)) return (int)cudaErrorInvalidValue;
  return dispatch<true>(base_args(H, W, C, Cmid), nullptr, nullptr, info,
                        nullptr);
}

}  // extern "C"
