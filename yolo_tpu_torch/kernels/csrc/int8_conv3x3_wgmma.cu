// Int8 conv3x3 (stride 1, pad 1) + fixed-point requant, for Hopper
// (sm_90a), on wgmma fed by a TMA ring: int8 NHWC [B, H, W, Cin] at scale
// 2^sa_in, Cin % 32 == 0 -> int8 [B, H, W, Cout], any Cout >= 1; and its
// pooled form, the same conv + a 2x2/2 max pool -> int8 [B, H/2, W/2,
// Cout], H and W even, Cin % 32 == 0 or Cin == 16; and its stride-2 form,
// conv3x3 with stride 2, pad 1 -> int8 [B, (H + 1) / 2, (W + 1) / 2,
// Cout], Cin % 32 == 0, H and W odd or even. Plain C interface, loaded
// with ctypes by yolo_tpu_torch/kernels/int8_conv.py, whose
// int8_conv3x3_requant and int8_conv_requant send every conv of the first
// shape here (conv3x3_wgmma_route), int8_conv_requant every one of the
// third (conv3x3_s2_wgmma_route) and int8_conv3x3_im2col every pooled
// conv of the second (conv3x3_pool_wgmma_route); the weights are packed
// K-major once per model (pack_conv3x3_weights) as [Cout, 9 * CK] in (dy,
// dx, c) order, CK = Cin rounded up to 32 (zero weights past Cin).
//
// Replaces the Pallas TPU kernels K1 _conv_kernel / int8_conv3x3_requant
// (all six K1 layers of slim_yolo_v2) and K3 _im2col_kernel /
// int8_conv3x3_im2col(pool=True) (slim's conv2, conv3_2 and conv4_2) of
// yolo_tpu/kernels/int8_conv.py, and XLA's integer conv in
// yolo_tpu/quant/fixed_point.py::int_conv_requant at the yolo_v3 head's
// nine stride-1 3x3s and (the stride-2 form) darknet53's five
// downsampling convs. The leaky slope is 0.125, none, or any Q16
// rational (the darknet 0.1); both roundings.
//
// What bounds it on an H100: 18 * Cin * Cout ops per conv pixel against
// Cin bytes in and Cout (pooled: Cout / 4) out, so every routed layer with
// Cin >= 64 is bound by operations (1,979 dense int8 TOPS) and slim's
// conv3_1 (32 -> 64, ~385 ops per byte) and conv2 (16 -> 32) by bytes
// (3.35 TB/s); at stride 2 the same ops per output pixel read 4 Cin bytes,
// so darknet53's 416 -> 208 (Cin 32) and 208 -> 104 (Cin 64) are bound
// by bytes, its deeper three by operations. The design is the 3x3 phase
// of the fused residual block
// (int8_res_block.cu), with its input loaded instead of computed; its
// pieces are shared through int8_wgmma_conv.cuh. Each block owns a TH x TW
// output tile of one image (plan_tile: up to 26 x 26, halved until it
// fits; in the pooled form even, and halved until the form's blocks per
// SM fit; at stride 2 plan_tile_s2, the tile with the fewest M steps per
// image, over slabs of the channels where that needs them) and
//   1. copies the tile plus a one-pixel halo of x, CK channels, into
//      shared memory, zero outside the image (the conv's padding) and past
//      Cin, rows CK + 16 bytes apart so that the 8 rows of an ldmatrix
//      fall in 8 different 16-byte bank groups. At stride 2 it copies the
//      (2TH + 1) x (2TW + 1) input pixels the tile reads, each halo row
//      as its even columns and then its odd ones: output pixel px reads
//      at tap dx = 0, 1, 2 slot px, TW + 1 + px and px + 1, so the rows of
//      consecutive pixels stay CK + 16 bytes apart (rows two pixels apart
//      would fall in 4 bank groups: a 2-way conflict on every A load) and
//      the tap offsets stay additions. At 52^2 and 26^2 a halo of all
//      channels leaves thin tiles (26 x 2), so the halo holds a slab of
//      128 channels and each slab's nine taps run before the next slab is
//      copied over it (the weights' K walk follows, by TMA box
//      coordinates: no other packing). The copy is cp.async, 16
//      bytes per thread (zero-filled where it reads nothing), not 4-D TMA
//      boxes: the padded rows let the 3x3 phase below run unchanged, where
//      a TMA box (<= 128 channels of one 128-byte swizzled row) would need
//      a swizzle XOR in every ldmatrix address and one box per 128
//      channels. The producer warp's first weight stages are in flight
//      meanwhile;
//   2. runs the 3x3 as an implicit GEMM [tile pixels, 9 * CK] x
//      [9 * CK, Cout] on wgmma (RS): each consumer warpgroup loads its A
//      fragments straight from the tile with ldmatrix, taps outside and
//      channels inside, so the tap offsets are additions; the weights
//      stream through a shared-memory ring of 3-8 stages that TMA fills
//      (128-byte swizzle, full / empty mbarriers), rows past Cout
//      zero-filled, so Cout = 35 runs in one 64-column tile. The pooled
//      form orders the M rows by 2x2 window: M row 16 w + g + 8 h of a
//      64-row step is window pixel (dy, dx) = (h, g % 2) of the step's
//      pooled pixel 4 w + g / 2, so each thread's accumulator holds both
//      rows of a window column and lane ^ 4 the other column (ldmatrix
//      takes any row order, so the MMA loop is the same);
//   3. requantizes in registers (every shift one branch-free form set up
//      on the host), stages 64 x 64 bytes per warpgroup in shared memory
//      and stores 16 bytes at a time (byte by byte, masked at Cout, where
//      Cout % 16 != 0 leaves the output rows unaligned). The pooled form
//      first takes each window's max on the int32 accumulator, as the TPU
//      kernel does (exact: the requant chain is monotone): over h in
//      registers, then over dx with one shuffle per two values, which
//      also leaves each of the two lanes half of the columns, so the
//      requant runs once per pooled value (1/4 of the unpooled epilogue),
//      and stages 16 x BN bytes.
// Three consumer warpgroups share each weight tile where Cout % 128 == 0
// (a producer warpgroup hands them its registers); else two, with a
// 64-column tile and one producer warp, two blocks per SM where the tile
// and ring fit in half an SM, or in the pooled form where Cout <= 32
// (slim's conv2) a 32-column tile and three blocks per SM. On an H100 the
// pooled form's latency-bound narrow layers ran 19-29% faster with the
// tile shrunk until those blocks reside (slim's conv3_2: 26 x 14 tiles,
// two blocks per SM, against one of 26 x 26) and with three conv2 blocks
// per SM against two (PERF.md, section 6).
//
// The shifts follow yolo_tpu/quant/fixed_point.py::_shift, including
// s >= 32 and s < 0.
//
// All three forms also run with one accumulator shift per output column
// (Cols::column: a per-channel sw, quantize_model(per_channel=True) of the
// JAX package; every slim layer but conv1 on NHWC input, and with
// quantize_pipeline_yolo_v3(per_channel=True) the yolo_v3 head's nine
// 3x3s and darknet53's five stride-2 convs), read from a table beside the
// bias, an int2 per column pair, each Shift made in registers from its
// entry (column_shift: the table, made on the host, already maps
// _shift_arr onto _shift), and the conv and pooled forms with them
// counting the outputs that hit the int16 clamp (Cols::count:
// int8_forward_diagnostics; the pooled form counts each window's four
// values before its max), each warp's count summed by one shuffle
// reduction and added by one atomic. Both are template forms: the scalar
// instantiations are those of before.
//
// The two-part form (PARTS) is the stride-1 conv over the channel concat
// of two int8 parts at their own scales, Cin0 and Cin1 each % 32 == 0:
// XLA's integer conv in yolo_tpu/quant/fixed_point.py::int_conv_requant
// over a list of two parts (:712-741), at tiny_yolo_v3's conv_set_1 ([256,
// 128] -> 256, 26^2, one scale) and yolo_v2's convsets_2.0 ([256, 1024]
// -> 1024, 13^2, two). Both parts are copied into one halo tile, rows of
// Cin0 + Cin1 channels (part 0's, then part 1's), and the K walk runs part
// 0's nine taps x Cin0 and then part 1's nine taps x Cin1, each part on
// K steps of its own, over weights packed [Cout, 9 Cin0 + 9 Cin1], part
// 0's (dy, dx, c) block and then part 1's (pack_conv3x3_parts_weights).
// Where both parts take one accumulator shift their raw partials sum in
// one accumulator (the conv over the concat); where they take two
// (split), part 0's partial is shifted to the retune scale at the part
// boundary into a second register array, as the 1x1 kernel does
// (int8_conv1x1_wgmma.cu). The split forms run the 64-column two-warpgroup
// tile (the 128-column one's 152 registers hold no second accumulator).
// A one-scale concat keeps the 128-column tile where Cout % 128 == 0. The
// halo of both parts leaves a tile of plan_tile's halving: 26 x 7 at
// conv_set_1 (384 channels, a 3-stage ring; split: 26 x 13 on the
// 64-column tile), 13 x 4 at convsets_2.0 (1,280 channels; 3 stages, or
// split 6). The form's blocks run one per SM (its halo fills one). On an
// H100 conv_set_1 ran 5.5x faster than on the mma.sync conv and near
// cuDNN's fp16 time; convsets_2.0's 52-pixel tiles, each streaming all
// 11.8 MB of its weights, only 1.3x (PERF.md, section 6), which the slab
// walk below takes over. Its arguments sit in a derived struct that only
// its instantiations take: the one-part instantiations are those of
// before.
//
// The slab walk (SLAB) runs the stride-1 conv and its two-part form over
// halo slabs of 128 channels, for the convs whose halo of all channels
// leaves thin tiles (slab_walk: C_in >= 1,024, each part's a multiple of
// 128: yolo_v2's convsets_1.0 and convsets_1.1, 1,024 -> 1,024, and
// convsets_2.0, [256, 1,024] -> 1,024, and tiny_yolo_v3's conv_set_2,
// 1,024 -> 256, at 13^2). A block takes a whole
// 13 x 13 image (plan_tile_slabs) with three consumer warpgroups at every
// tile width (the 64-column split's too, whose two warpgroups would take
// two 128-row M steps, each streaming every weight and re-copying every
// slab): 169 of the 192 rows of its M step on pixels, against 52 pixels
// per 13 x 4 tile over a halo of all 1,024 channels, and each weight tile
// streams once per image instead of four times. Each slab's nine taps run
// before the next slab's, the weights' K walk following by TMA box
// coordinates (kcol; no other packing); with two parts a slab lies in one
// part, and a split shifts part 0's partial into the stash after its
// last slab. The halo tile is two slab buffers: the consumers copy slab
// s + 1 into one (cp.async, its landing counted on an mbarrier) while
// slab s's MMAs read the other, which a second mbarrier hands back once
// every consumer warp has read it, so no slab stops the block. Where the
// batch leaves SMs idle (batch 64 at 13^2: 64 blocks on 132 SMs) each
// image's weight tiles are split over 2 or 4 blocks. The walk is a
// template form, one block per SM, that the stride-1 conv's and the
// two-part form's C entries (scalar and per column) launch themselves
// where slab_walk takes the conv (dispatch, dispatch_parts; their _info
// entries report its layout at a batch of B): the other instantiations
// are those of before (their SASS too).

#include <type_traits>

#include "int8_wgmma_conv.cuh"

namespace {

// WIDE: three consumer warpgroups (the 128-column tile's, and the slab
// walk's at every width: a 192-row M step holds a whole 13 x 13 image)
template <int BN, bool WIDE = BN == 128>
struct ConvCfg {
  // consumer warpgroups, each owning 64 rows of an M step
  static constexpr int NWG = WIDE ? 3 : 2;
  static constexpr int CONSUMERS = 128 * NWG;
  // + the producer: a whole warpgroup that hands its registers to the
  // consumers (setmaxnreg) in the wide form, one warp in the narrow forms
  static constexpr int THREADS = NWG == 3 ? 512 : CONSUMERS + 32;
  // blocks per SM where the tile and ring fit in their share of it
  static constexpr int MIN_BLOCKS = BN == 128 ? 1 : BN == 64 ? 2 : 3;
  // a ring slot: two weight tiles (BN rows each), one 256-deep K step
  static constexpr int SLOT = 2 * BN * SW;
};

// the kernel's forms: the conv, its pooled form, its stride-2 form
enum class Form { conv, pool, s2 };
// its accumulator shifts: one for the layer (Epi's), one per output column
// from a shift table (a per-channel sw), or per column counting the values
// that reach the int16 clamp (int8_forward_diagnostics; the general shift
// form only; the conv and pooled forms only)
enum class Cols { scalar, column, count };

struct Conv3Args {
  const int8_t* x;  // [B, H, W, Cin]
  const int* bias;  // [Cout rounded up to 128], retune scale, 0 past Cout
  int8_t* out;      // [B, H, W, Cout], pooled [B, H / 2, W / 2, Cout],
                    // stride 2 [B, (H + 1) / 2, (W + 1) / 2, Cout]
  int B, H, W, Cin, Cout;
  int CK;        // channels of each tap's K: Cin rounded up to 32
  int SL;        // channels of the halo tile: CK, or (stride 2) a slab
  int TH, TW;    // output tile (the edge tiles may be smaller)
  int stages;    // ring depth, 3..MAX_STAGES
  Epi epi;
  // Cols::column, count: the accumulator shift table ([Cout rounded up to
  // 128], int8_conv.py's acc_shift_table, 0 past Cout), and with count
  // the int32 the block's counts are added to
  const int* shifts;
  int* overflow;
};

// the two-part form's arguments (PARTS): x is part 0, Cin and CK both
// parts' channels (the halo tile's), `shifts` the last part's table (every
// part's where they take one shift)
struct Conv3PartsArgs : Conv3Args {
  const int8_t* x1;      // part 1 [B, H, W, Cin - Cin0]
  int Cin0;              // part 0's channels
  int split;             // the parts take two accumulator shifts
  Shift sh0;             // Cols::scalar: part 0's shift, where split
  const int* shifts0;    // Cols::column: part 0's table, where split
};

template <bool PARTS>
using Conv3ArgsOf = std::conditional_t<PARTS, Conv3PartsArgs, Conv3Args>;

// staging byte of (row, column) of the pooled form's 16 x BN tile: the
// 16-byte chunks XOR-ed with the row, so the 4 rows that a warp's 2-byte
// stores reach at once fall in 4 different bank groups
template <int BN>
__device__ __forceinline__ int pool_stg_at(int row, int col) {
  return row * BN + ((((col >> 4) ^ row) & (BN / 16 - 1)) << 4) + (col & 15);
}

template <int BN, bool SHORT, Form F, Cols C, bool PARTS = false,
          bool SLAB = false>
__global__ void __launch_bounds__(ConvCfg<BN, BN == 128 || SLAB>::THREADS,
                                  PARTS || SLAB ? 1 : ConvCfg<BN>::MIN_BLOCKS)
conv3x3_wgmma(const __grid_constant__ CUtensorMap tm_w,
              Conv3ArgsOf<PARTS> a) {
  using Cfg = ConvCfg<BN, BN == 128 || SLAB>;
  constexpr int NWG = Cfg::NWG, CONSUMERS = Cfg::CONSUMERS;
  constexpr bool POOL = F == Form::pool, S2 = F == Form::s2;
  constexpr bool COUNT = C == Cols::count;
  static_assert(!COUNT || !S2, "stride 2 counts no overflow");
  static_assert(!COUNT || !SHORT, "counting takes the general shifts");
  static_assert(!PARTS || (F == Form::conv && !COUNT),
                "two parts: the stride-1 conv, scalar or per column");
  static_assert(!SLAB || (F == Form::conv && !COUNT),
                "the slab walk: the stride-1 conv, scalar or per column");
  // a second accumulator for part 0's shifted partial: the two-part
  // 64-column forms (the host runs a split there only)
  constexpr bool CAN_SPLIT = PARTS && BN == 64;
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dsmem) + 1023) & ~uintptr_t(1023));
  // the halo tile: (TH + 2) x (TW + 2) pixels; at stride 2, 2TH + 1 rows
  // of 2TW + 1, each row its even input columns and then its odd ones
  // (SLAB: two of them, buffers 0 and 1, HB bytes apart)
  const int HW = S2 ? 2 * a.TW + 1 : a.TW + 2;
  const int SL = S2 || SLAB ? a.SL : a.CK, S = y1_stride(SL);
  int8_t* xt = reinterpret_cast<int8_t*>(smem + a.stages * Cfg::SLOT);
  const int HB = halo_bytes(a.TH, a.TW, SL, S2 ? 2 : 1);
  int8_t* stg_all = xt + HB;
  if constexpr (SLAB) stg_all += HB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stg_all + NWG * STG_BYTES);
  const Ring ring{bars, bars + a.stages, a.stages};
  // SLAB: hfull[u] completes when a slab has landed in buffer u (every
  // consumer thread's copies), hempty[u] when every consumer warp has read
  // it
  uint64_t* hfull = bars + 2 * a.stages;
  uint64_t* hempty = hfull + 2;
  const int tid = threadIdx.x;

  // ---- this block's tile, on the output grid (pooled form: before the
  // pool); SLAB: and its group of weight tiles, groups = the grid's blocks
  // per tile
  const int OH = S2 ? (a.H + 1) / 2 : a.H, OW = S2 ? (a.W + 1) / 2 : a.W;
  const int ntx = (OW + a.TW - 1) / a.TW, nty = (OH + a.TH - 1) / a.TH;
  // (unsigned, as blockIdx.x: a signed division here alone changed the
  // SASS of every other instantiation)
  unsigned bt = blockIdx.x;
  int grp = 0, groups = 1;
  if constexpr (SLAB) {
    groups = gridDim.x / (a.B * ntx * nty);
    grp = bt % groups;
    bt /= groups;
  }
  const int b = bt / (ntx * nty);
  const int t = bt - b * ntx * nty;
  const int ty0 = (t / ntx) * a.TH, tx0 = (t % ntx) * a.TW;
  const int th = min(a.TH, OH - ty0), tw = min(a.TW, OW - tx0);

  // ---- the producer's and the consumers' common walk over the ring: per
  // M step and weight tile, each halo slab's nine taps (one slab but at
  // stride 2 and in the slab walk), K-steps of 2 x SW channels over (tap,
  // channel of the slab)
  const int KS = 9 * SL, nk = (KS + 2 * SW - 1) / (2 * SW);
  // (stride-2 slabs only in the 128-column form: the 64-column one keeps
  // under the registers of its two blocks per SM)
  const int nslab = (S2 && BN == 128) || SLAB ? a.CK / SL : 1;
  int nn = (a.Cout + BN - 1) / BN, n0 = 0;
  if constexpr (SLAB) {  // this block's weight tiles n0 .. nn - 1
    const int per = (nn + groups - 1) / groups;
    n0 = grp * per;
    nn = min(nn, n0 + per);
  }
  // M steps of NWG x 64 rows over the nominal tile: its pixels, or in the
  // pooled form its pooled pixels, 16 (64 rows) per warpgroup
  const int PW = a.TW / 2, Q = a.TH / 2 * PW;  // the pooled tile
  const int nc = POOL ? (Q + 16 * NWG - 1) / (16 * NWG)
                      : (a.TH * a.TW + 64 * NWG - 1) / (64 * NWG);

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], CONSUMERS / 32);
    }
    if constexpr (SLAB)
      for (int u = 0; u < 2; ++u) {
        mbar_init(&hfull[u], CONSUMERS);
        mbar_init(&hempty[u], CONSUMERS / 32);
      }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    if constexpr (NWG == 3)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if constexpr (PARTS && !SLAB) {
      if (tid != CONSUMERS) return;
      tma_prefetch_map(&tm_w);
      // each part's own K steps: part 0's nine taps x Cin0 from packed
      // column 0, part 1's from column 9 Cin0 (a box past a part's end
      // is loaded, and not read)
      int i = 0;
      for (int c = 0; c < nc; ++c)
        for (int n = n0; n < nn; ++n)
          for (int p = 0; p < 2; ++p) {
            const int base = p ? 9 * a.Cin0 : 0;
            const int kp = p ? KS - base : 9 * a.Cin0;  // the part's K
            for (int k = 0; k * 2 * SW < kp; ++k, ++i) {
              const bool two = k * 2 * SW + SW < kp;
              ring.producer_acquire(i, (two ? 2 : 1) * BN * SW);
              unsigned char* st = smem + ring.stage(i) * Cfg::SLOT;
              uint64_t* full = &ring.full[ring.stage(i)];
              tma_load_2d(st, &tm_w, full, base + k * 2 * SW, n * BN);
              if (two)
                tma_load_2d(st + BN * SW, &tm_w, full, base + k * 2 * SW + SW,
                            n * BN);
            }
          }
    } else if (tid == CONSUMERS) {  // (the one-part walk)
      tma_prefetch_map(&tm_w);
      // the packed K column of channel v of a slab's (tap, channel)
      // walk: one box never straddles two taps where there are slabs
      // (SL % SW == 0); two parts: slab s lies in one part, whose (dy, dx,
      // c) block starts at packed column 9 Cin0 for part 1
      const auto kcol = [=](int v, int s) {
        if constexpr (PARTS) {
          const bool p1 = s * SL >= a.Cin0;
          const int c0 = p1 ? a.Cin0 : 0;  // the part's first channel
          return 9 * c0 + v / SL * (p1 ? a.Cin - a.Cin0 : a.Cin0) +
                 s * SL - c0 + v % SL;
        }
        return S2 || SLAB ? v / SL * a.CK + s * SL + v % SL : v;
      };
      int i = 0;
      for (int c = 0; c < nc; ++c)
        for (int n = n0; n < nn; ++n)
          for (int k = 0, s = 0; k < nk; ++k, ++i) {
            const bool two = k * 2 * SW + SW < KS;
            ring.producer_acquire(i, (two ? 2 : 1) * BN * SW);
            unsigned char* st = smem + ring.stage(i) * Cfg::SLOT;
            uint64_t* full = &ring.full[ring.stage(i)];
            tma_load_2d(st, &tm_w, full, kcol(k * 2 * SW, s), n * BN);
            if (two)
              tma_load_2d(st + BN * SW, &tm_w, full, kcol(k * 2 * SW + SW, s),
                          n * BN);
            if (nslab > 1 && k == nk - 1 && ++s < nslab) k = -1;  // next slab
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
  // and of its output
  const long long oimg = S2 ? (long long)b * OH * OW : img;

  // ---- 1. the halo tile of x (slab s of its channels), zero outside the
  // image and past Cin. The kernel's lambdas capture by value: capturing
  // by reference took the addresses of S and CK, which then left the
  // uniform registers, and the tap walk below became a branch at every
  // 32-channel step (the stride-1 and pooled forms 3-7% slower on an H100,
  // PERF.md, section 6)
  const auto copy_halo = [=](int s, int8_t* dst) {
    const int chunks = SL / 16;  // 16-byte chunks per pixel
    const int HH = S2 ? 2 * a.TH + 1 : a.TH + 2;
    for (int e = tid; e < HH * HW * chunks; e += CONSUMERS) {
      const int p = e / chunks, q = e - p * chunks;
      const int hy = p / HW, hx = p - hy * HW;
      // input pixel, and its place in the halo tile
      int gy = ty0 - 1 + hy, gx = tx0 - 1 + hx, at = p;
      if constexpr (S2) {
        gy = 2 * ty0 - 1 + hy;
        gx = 2 * tx0 - 1 + hx;
        at = hy * HW + (hx & 1 ? a.TW + 1 : 0) + (hx >> 1);
      }
      const int cq = s * SL + 16 * q;
      const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W &&
                      cq < a.Cin;
      const int8_t* src;
      if constexpr (PARTS) {
        // channel cq of the concat: part 0's, or part 1's cq - Cin0
        const bool p1 = cq >= a.Cin0;
        const int cp = p1 ? a.Cin - a.Cin0 : a.Cin0;
        src = in ? (p1 ? a.x1 : a.x) +
                       (img + (long long)gy * a.W + gx) * cp +
                       (p1 ? cq - a.Cin0 : cq)
                 : a.x;
      } else {
        src = in ? a.x + (img + (long long)gy * a.W + gx) * a.Cin + cq : a.x;
      }
      cp_async16(dst + at * S + 16 * q, src, in ? 16 : 0);
    }
  };
  if (!SLAB && nslab == 1) {
    copy_halo(0, xt);
    cp_async_wait_all();
    named_sync(1, CONSUMERS);  // the tile complete
  }
  // slab s over the last one, once all consumers have read it
  const auto load_slab = [=](int s) {
    named_sync(1, CONSUMERS);
    copy_halo(s, xt);
    cp_async_wait_all();
    named_sync(1, CONSUMERS);
  };
  // SLAB: the block's J slabs in walk order (M step, weight tile, slab),
  // the sj-th in buffer sj % 2: each is copied while the one before it is
  // read, once the one before that (the buffer's last) has been read by
  // every consumer warp
  const int J = nc * (nn - n0) * nslab;
  int sj = 0;
  const auto fill = [=](int q) {
    copy_halo(q % nslab, xt + (q & 1) * HB);
    cp_async_arrive(&hfull[q & 1]);
  };
  if constexpr (SLAB) fill(0);

  // ---- 2. the 3x3 over the tile, 3. requant
  int8_t* stg = stg_all + wg * STG_BYTES;
  const bool nearest = a.epi.rnd != 0;
  int cnt = 0;  // Cols::count: values outside int16, this thread's
  int i = 0;
  for (int c = 0; c < nc; ++c) {
    bool active;
    const int8_t* arow;
    // Cols::count: whether each of this thread's accumulator rows is a
    // pixel of the image (the pooled form: whether its pooled pixel is)
    int rv[2] = {0, 0};
    // output byte offsets of the 16-byte chunks this thread copies out, or
    // -1 outside the image (the pooled form: one chunk)
    long long obase[2];
    if constexpr (POOL) {
      const int q0 = (c * NWG + wg) * 16;  // the step's first pooled pixel
      active = q0 < th / 2 * PW;  // later ones lie below the image
      // this lane's ldmatrix row g + 8 h (g = lane % 8, h = lane / 8 % 2):
      // pixel (h, g % 2) of pooled pixel q
      int q = q0 + warp * 4 + ((lane & 7) >> 1);
      if (q >= Q) q = 0;
      const int qy = q / PW;
      const int py = 2 * qy + ((lane >> 3) & 1);
      const int px = 2 * (q - qy * PW) + (lane & 1);
      arow = xt + (py * HW + px) * S + 16 * (lane >> 4);
      // chunk ltid % NCH of pooled pixel q0 + ltid / NCH
      constexpr int NCH = BN / 16;
      const int qq = q0 + ltid / NCH;
      const int oy = qq / PW, ox = qq - oy * PW;
      if constexpr (COUNT) {
        // the accumulator rows g, g + 8 of pooled pixel 4 warp + g / 2
        const int qa = q0 + warp * 4 + (gid >> 1);
        const int ay = qa / PW, ax = qa - ay * PW;
        rv[0] = rv[1] = qa < Q && ay < th / 2 && ax < tw / 2;
      }
      obase[0] = ltid < 16 * NCH && oy < th / 2 && ox < tw / 2
                     ? ((long long)b * (a.H / 2) * (a.W / 2) +
                        (long long)(ty0 / 2 + oy) * (a.W / 2) + tx0 / 2 +
                        ox) * a.Cout
                     : -1;
    } else {
      const int P = a.TH * a.TW;  // rows of the nominal tile
      const int p0 = (c * NWG + wg) * 64;
      active = p0 < th * a.TW;  // rows from here on lie below the image
      // this lane's ldmatrix row: output pixel r of the tile, at tap (0, 0)
      // halo pixel (py, px), at stride 2 (2 py, 2 px): slot px of the even
      // columns of halo row 2 py
      int r = p0 + warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      if (r >= P) r = 0;
      const int py = r / a.TW, px = r - py * a.TW;
      arow = xt + ((S2 ? 2 * py : py) * HW + px) * S + 16 * (lane >> 4);
      if constexpr (COUNT) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pa = p0 + warp * 16 + gid + 8 * h;
          const int ay = pa / a.TW, ax = pa - ay * a.TW;
          rv[h] = pa < P && ay < th && ax < tw;
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int po = p0 + ((ltid + 128 * q) >> 2);
        const int oy = po / a.TW, ox = po - oy * a.TW;
        obase[q] = oy < th && ox < tw
                       ? (oimg + (long long)(ty0 + oy) * OW + tx0 + ox) *
                             a.Cout
                       : -1;
      }
    }
    for (int n = n0; n < nn; ++n) {
      int acc[BN / 2];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
      // (tap, channel) of the next 32-deep K step: tile offset tap_off
      // + ch, tap_off = (dy * HW + dx) * S; at stride 2 (dy * HW + c)
      // * S, c the slot of halo column dx: 0, TW + 1 (the odd columns)
      // and 1
      int tap_off = 0, ch = 0, dx = 0;
      // PARTS: the current part's K, K steps and channels (part 0's, then
      // part 1's, whose channels start at Cin0 in the halo rows), and
      // where split part 0's partial at the retune scale
      int kp = KS, nkp = nk, wl = SL, part = 0;
      int stash[CAN_SPLIT ? BN / 2 : 1];
      if constexpr (PARTS && !SLAB) {
        kp = 9 * a.Cin0;
        nkp = (kp + 2 * SW - 1) / (2 * SW);
        wl = a.Cin0;
      }
      if constexpr (CAN_SPLIT) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) stash[e] = 0;
      }
      if (!SLAB && nslab > 1) load_slab(0);
      for (int k = 0, s = 0; k < (PARTS && !SLAB ? nkp : nk); ++k, ++i) {
        if (SLAB && k == 0) {  // slab sj landed: its taps from its buffer
          mbar_wait(&hfull[sj & 1], (sj >> 1) & 1);
          tap_off = (sj & 1) * HB;
        }
        ring.consumer_wait(i);
        if (active) {
          const unsigned char* st = smem + ring.stage(i) * Cfg::SLOT;
          const uint64_t db = desc_sw128(st);
          // the step's two 128-deep halves (one weight tile each), four
          // 32-deep A fragments in registers at a time
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (half == 1) wgmma_wait<0>();  // the first half's A retired
            unsigned af[SW / 32][4];
#pragma unroll
            for (int j = 0; j < SW / 32; ++j) {
              if (k * 2 * SW + half * SW + 32 * j < (PARTS ? kp : KS)) {
                ldmatrix_x4(af[j], arow + tap_off + ch);
                ch += 32;
                if (ch == (PARTS ? wl : SL)) {
                  ch = 0;
                  if (++dx == 3) {
                    dx = 0;
                    tap_off += (HW - (S2 ? 1 : 2)) * S;
                  } else if constexpr (S2) {
                    tap_off += (dx == 1 ? a.TW + 1 : -a.TW) * S;
                  } else {
                    tap_off += S;
                  }
                }
              }
            }
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < SW / 32; ++j)
              if (k * 2 * SW + half * SW + 32 * j < (PARTS ? kp : KS))
                mma_rs<BN>(acc, af[j], db + ((half * BN * SW + j * 32) >> 4));
            wgmma_commit();
          }
          wgmma_wait<0>();
        }
        ring.consumer_release(i);
        if constexpr (SLAB) {
          // slab sj + 1 into the other buffer, once every warp has read
          // slab sj - 1 there
          if (k == 0 && sj + 1 < J) {
            if (sj > 0) mbar_wait(&hempty[(sj + 1) & 1], ((sj - 1) >> 1) & 1);
            fill(sj + 1);
          }
          if (k == nk - 1) {  // this warp's reads of slab sj are done
            __syncwarp();
            if (lane == 0) mbar_arrive(&hempty[sj & 1]);
            ++sj;
          }
        }
        if constexpr (PARTS) {
          // part 0 done: part 1 next (SLAB: its last slab done, part 1's
          // slabs next, each of one part)
          if (SLAB ? k == nk - 1 && (s + 1) * SL == a.Cin0
                   : part == 0 && k == nkp - 1) {
            if constexpr (!SLAB) {
              part = 1;
              kp = KS - kp;
              nkp = (kp + 2 * SW - 1) / (2 * SW);
              wl = a.Cin - a.Cin0;
              tap_off = a.Cin0;
              ch = dx = 0;
              k = -1;
            }
            if constexpr (CAN_SPLIT) {
              // its partial to the retune scale, part 1's afresh; columns
              // 8 jj + 2 tig (+1) of the tile: accumulators 4 jj + 2 h (+1)
              if (a.split && active) {
#pragma unroll
                for (int jj = 0; jj < BN / 8; ++jj) {
                  Shift s0 = a.sh0, s1 = a.sh0;
                  if constexpr (C == Cols::column) {
                    const int2 sc = __ldg(reinterpret_cast<const int2*>(
                        a.shifts0 + n * BN + 8 * jj + 2 * tig));
                    s0 = column_shift<SHORT>(sc.x, nearest);
                    s1 = column_shift<SHORT>(sc.y, nearest);
                  }
#pragma unroll
                  for (int e = 4 * jj; e < 4 * jj + 4; e += 2) {
                    stash[e] = s0.apply<SHORT>(acc[e]);
                    stash[e + 1] = s1.apply<SHORT>(acc[e + 1]);
                    acc[e] = acc[e + 1] = 0;
                  }
                }
              }
            }
          }
        }
        if (nslab > 1 && k == nk - 1 && ++s < nslab) {  // the next slab
          if constexpr (!SLAB) load_slab(s);
          tap_off = ch = dx = 0;
          k = -1;
        }
      }
      if (!active) continue;
      if constexpr (POOL) {
        // Each window's max: over its rows g, g + 8 (dy) in this thread's
        // registers, then over its columns (dx = g % 2) with lane ^ 4, each
        // lane keeping the n8 groups j of its own dx parity (sending the
        // other); then requant, stage and store BN columns of 16 pooled
        // pixels. The thread's values: pooled pixel 4 warp + g / 2,
        // columns 8 j + 2 tig (+1), j = 2 i + dx.
        const int odd = gid & 1;
        const int row = warp * 4 + (gid >> 1);
#pragma unroll
        for (int h = 0; h < BN / 16; ++h) {
          if constexpr (COUNT) {
            // the four values of each window, before its max: n8 groups
            // 2h and 2h + 1 (this thread's dx), rows g and g + 8 (dy)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int cc = n * BN + 16 * h + 8 * jj + 2 * tig;
              const int2 bb = *reinterpret_cast<const int2*>(a.bias + cc);
              const int2 sc =
                  __ldg(reinterpret_cast<const int2*>(a.shifts + cc));
              const Shift s0 = column_shift<false>(sc.x, nearest);
              const Shift s1 = column_shift<false>(sc.y, nearest);
#pragma unroll
              for (int r2 = 0; r2 < 2; ++r2) {
                const int* u = &acc[8 * h + 4 * jj + 2 * r2];
                if (rv[0])
                  cnt += out_of_int16((int)((unsigned)s0.apply<false>(u[0]) +
                                            (unsigned)bb.x)) +
                         out_of_int16((int)((unsigned)s1.apply<false>(u[1]) +
                                            (unsigned)bb.y));
              }
            }
          }
          int v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m0 = max(acc[8 * h + e], acc[8 * h + 2 + e]);
            const int m1 = max(acc[8 * h + 4 + e], acc[8 * h + 6 + e]);
            v[e] = max(odd ? m1 : m0,
                       __shfl_xor_sync(0xffffffffu, odd ? m0 : m1, 4));
          }
          const int cl = 16 * h + 8 * odd + 2 * tig;
          const int2 bias =
              *reinterpret_cast<const int2*>(a.bias + n * BN + cl);
          uint16_t* dst =
              reinterpret_cast<uint16_t*>(stg + pool_stg_at<BN>(row, cl));
          if constexpr (C == Cols::scalar) {
            *dst = pack2(a.epi.apply<SHORT>(v[0], bias.x),
                         a.epi.apply<SHORT>(v[1], bias.y));
          } else {
            const int2 sc =
                __ldg(reinterpret_cast<const int2*>(a.shifts + n * BN + cl));
            *dst = pack2(
                a.epi.apply<SHORT>(column_shift<SHORT>(sc.x, nearest), v[0],
                                   bias.x),
                a.epi.apply<SHORT>(column_shift<SHORT>(sc.y, nearest), v[1],
                                   bias.y));
          }
        }
        named_sync(2 + wg, 128);
        constexpr int NCH = BN / 16;
        const int c16 = ltid % NCH;
        const int left = a.Cout - n * BN - 16 * c16;  // columns to store
        if (obase[0] >= 0 && left > 0) {
          const uint4 o = *reinterpret_cast<const uint4*>(
              stg + pool_stg_at<BN>(ltid / NCH, 16 * c16));
          int8_t* dst = a.out + obase[0] + n * BN + 16 * c16;
          if (a.Cout % 16 == 0) {
            *reinterpret_cast<uint4*>(dst) = o;
          } else {
            const int8_t* ob = reinterpret_cast<const int8_t*>(&o);
#pragma unroll
            for (int e = 0; e < 16; ++e)
              if (e < left) dst[e] = ob[e];
          }
        }
        named_sync(2 + wg, 128);
      } else {
        // 64 columns at a time through the warpgroup's staging tile
#pragma unroll
        for (int pass = 0; pass < BN / 64; ++pass) {
          const int col0 = n * BN + pass * 64;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int cl = 8 * j + 2 * tig;
            const int2 bias =
                *reinterpret_cast<const int2*>(a.bias + col0 + cl);
            if constexpr (CAN_SPLIT) {
              // the last part's shift (every part's where not split; part
              // 0's partial, where split, already in the stash, else 0)
              Shift s0 = a.epi.acc, s1 = a.epi.acc;
              if constexpr (C == Cols::column) {
                const int2 sc =
                    __ldg(reinterpret_cast<const int2*>(a.shifts + col0 + cl));
                s0 = column_shift<SHORT>(sc.x, nearest);
                s1 = column_shift<SHORT>(sc.y, nearest);
              }
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int e = 4 * (8 * pass + j) + 2 * h;
                const int u0 = (int)((unsigned)s0.apply<SHORT>(acc[e]) +
                                     (unsigned)stash[e]);
                const int u1 = (int)((unsigned)s1.apply<SHORT>(acc[e + 1]) +
                                     (unsigned)stash[e + 1]);
                *reinterpret_cast<uint16_t*>(
                    stg + stg_at(warp * 16 + gid + 8 * h, cl)) =
                    pack_sat2(a.epi.rest<SHORT>(u0, bias.x),
                              a.epi.rest<SHORT>(u1, bias.y));
              }
            } else if constexpr (C == Cols::scalar) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int* v = &acc[4 * (8 * pass + j) + 2 * h];
                *reinterpret_cast<uint16_t*>(
                    stg + stg_at(warp * 16 + gid + 8 * h, cl)) =
                    pack2(a.epi.apply<SHORT>(v[0], bias.x),
                          a.epi.apply<SHORT>(v[1], bias.y));
              }
            } else {
              // this column pair's shifts, read through the read-only
              // cache (2-5% faster than as the bias is read, on an H100)
              const int2 sc =
                  __ldg(reinterpret_cast<const int2*>(a.shifts + col0 + cl));
              const Shift s0 = column_shift<SHORT>(sc.x, nearest);
              const Shift s1 = column_shift<SHORT>(sc.y, nearest);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int* v = &acc[4 * (8 * pass + j) + 2 * h];
                if (COUNT && rv[h])
                  cnt += out_of_int16((int)((unsigned)s0.apply<false>(v[0]) +
                                            (unsigned)bias.x)) +
                         out_of_int16((int)((unsigned)s1.apply<false>(v[1]) +
                                            (unsigned)bias.y));
                *reinterpret_cast<uint16_t*>(
                    stg + stg_at(warp * 16 + gid + 8 * h, cl)) =
                    pack2(a.epi.apply<SHORT>(s0, v[0], bias.x),
                          a.epi.apply<SHORT>(s1, v[1], bias.y));
              }
            }
          }
          named_sync(2 + wg, 128);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int rl = (ltid + 128 * q) >> 2, c16 = ltid & 3;
            const int left = a.Cout - col0 - 16 * c16;  // columns to store
            if (obase[q] < 0 || left <= 0) continue;
            const uint4 o =
                *reinterpret_cast<const uint4*>(stg + stg_at(rl, 16 * c16));
            int8_t* dst = a.out + obase[q] + col0 + 16 * c16;
            if (a.Cout % 16 == 0) {
              *reinterpret_cast<uint4*>(dst) = o;
            } else {
              const int8_t* ob = reinterpret_cast<const int8_t*>(&o);
#pragma unroll
              for (int e = 0; e < 16; ++e)
                if (e < left) dst[e] = ob[e];
            }
          }
          named_sync(2 + wg, 128);
        }
      }
    }
  }
  if constexpr (COUNT) {
    // one atomic per warp
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0 && cnt != 0) atomicAdd(a.overflow, cnt);
  }
}

// The stride-1 conv's slab walk takes the convs whose halo of all
// channels leaves thin tiles, C_in (both parts') >= 1,024 in whole slabs,
// each part's too (yolo_v2's convsets_1.x and convsets_2.0, tiny's
// conv_set_2, at 13^2: 13 x 4 tiles, 27% and 41% of their M rows on
// pixels, each tile streaming all the weights; a part of 96 channels
// keeps the tile walk).
bool slab_walk(int CK, int Cin0) {
  return CK >= 1024 && CK % SLAB_C == 0 && Cin0 % SLAB_C == 0;
}

// The form's layout for an H x W image whose taps hold CK channels: the
// output tile and ring of plan_tile (even, and small enough for the form's
// blocks per SM, in the pooled form) or, at stride 2, of plan_tile_s2,
// with its halo slab (int8_wgmma_conv.cuh), the ring in the block's share
// of an SM's shared memory (the two-part form's: all of it, one block per
// SM; CK then both parts' channels).
template <int BN, Form F, bool PARTS = false>
TilePlan plan(int H, int W, int CK, int Cout) {
  using Cfg = ConvCfg<BN>;
  if constexpr (F == Form::s2)
    return plan_tile_s2((H + 1) / 2, (W + 1) / 2, CK, Cfg::SLOT, Cfg::NWG,
                        sm_share(Cfg::MIN_BLOCKS), (Cout + BN - 1) / BN,
                        BN == 128);
  return plan_tile(H, W, CK, Cfg::SLOT, Cfg::NWG,
                   sm_share(PARTS ? 1 : Cfg::MIN_BLOCKS), F == Form::pool);
}

constexpr int INFO_LEN = 11;

// Launches the form, or with `info` reports its layout there instead; the
// slab walk (SLAB) on plan_tile_slabs' layout for a batch of B on the
// current device's SMs.
template <int BN, bool SHORT, Form F, Cols C, bool PARTS = false,
          bool SLAB = false>
int launch_form(Conv3ArgsOf<PARTS> a, const void* wp, int* info,
                cudaStream_t st) {
  using Cfg = ConvCfg<BN, BN == 128 || SLAB>;
  TilePlan p;
  cudaError_t err = cudaSuccess;
  if constexpr (SLAB) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    p = plan_tile_slabs(a.B, a.H, a.W, a.CK, Cfg::SLOT, Cfg::NWG,
                        (a.Cout + BN - 1) / BN, sms);
  } else {
    p = plan<BN, F, PARTS>(a.H, a.W, a.CK, a.Cout);
  }
  if (p.smem == 0) return (int)cudaErrorInvalidValue;
  a.TH = p.th;
  a.TW = p.tw;
  a.stages = p.stages;
  a.SL = p.slab;
  err = cudaFuncSetAttribute(conv3x3_wgmma<BN, SHORT, F, C, PARTS, SLAB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, conv3x3_wgmma<BN, SHORT, F, C, PARTS, SLAB>, Cfg::THREADS,
        p.smem);
    if (err != cudaSuccess) return (int)err;
    const int pixels = a.TH * a.TW;
    // 64 rows per step: 64 pixels, or the 4 pixels of 16 pooled ones
    const int steps =
        F == Form::pool ? (pixels / 4 + 15) / 16 : (pixels + 63) / 64;
    const int vals[INFO_LEN] = {a.TH,       a.TW,     p.smem,   blocks,
                                BN,         Cfg::NWG, a.stages, pixels,
                                64 * steps, a.SL,     p.groups};
    for (int k = 0; k < INFO_LEN; ++k) info[k] = vals[k];
    return 0;
  }
  CUtensorMap tm_w;
  const cuuint64_t K = 9 * (cuuint64_t)a.CK;
  const cuuint64_t dims[2] = {K, (cuuint64_t)a.Cout}, strides[1] = {K};
  const cuuint32_t box[2] = {SW, BN};
  const int rc = make_map(&tm_w, wp, 2, dims, strides, box);
  if (rc != 0) return rc;
  // the output grid the tiles cover (stride 2: (H + 1) / 2 x (W + 1) / 2)
  const int OH = F == Form::s2 ? (a.H + 1) / 2 : a.H;
  const int OW = F == Form::s2 ? (a.W + 1) / 2 : a.W;
  const long long ntiles =
      (long long)((OH + a.TH - 1) / a.TH) * ((OW + a.TW - 1) / a.TW);
  const unsigned blocks = (unsigned)(a.B * ntiles * p.groups);
  conv3x3_wgmma<BN, SHORT, F, C, PARTS, SLAB>
      <<<blocks, Cfg::THREADS, p.smem, st>>>(tm_w, a);
  return (int)cudaGetLastError();
}

// the 128-column form where Cout fills it, else the 64-column one, or in
// the pooled form the 32-column one where Cout <= 32; the stride-1 conv
// (scalar or per column) on its slab walk where slab_walk takes it
template <bool SHORT, Form F, Cols C = Cols::scalar>
int dispatch(const Conv3Args& a, const void* wp, int* info,
             cudaStream_t st) {
  if constexpr (F == Form::conv && C != Cols::count)
    if (slab_walk(a.CK, a.CK)) {
      if (a.Cout % 128 == 0)
        return launch_form<128, SHORT, F, C, false, true>(a, wp, info, st);
      return launch_form<64, SHORT, F, C, false, true>(a, wp, info, st);
    }
  if (a.Cout % 128 == 0)
    return launch_form<128, SHORT, F, C>(a, wp, info, st);
  if constexpr (F == Form::pool)
    if (a.Cout <= 32) return launch_form<32, SHORT, F, C>(a, wp, info, st);
  return launch_form<64, SHORT, F, C>(a, wp, info, st);
}

bool bad_shape(int H, int W, int Cin, int Cout, Form f) {
  if (H < 1 || W < 1 || Cout < 1) return true;
  if (f == Form::pool && (H % 2 || W % 2)) return true;
  if (f == Form::pool && Cin == 16) return false;  // zero-extended to 32
  return Cin < 32 || Cin % 32;
}

Conv3Args base_args(int H, int W, int Cin, int Cout) {
  Conv3Args a{};
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.CK = (Cin + 31) / 32 * 32;
  return a;
}

template <Form F>
int run(const void* x, const void* wp, const void* bias_rt, void* out, int B,
        int H, int W, int Cin, int Cout, int acc_shift, int out_shift,
        int slope_num, int nearest, void* stream) {
  if (bad_shape(H, W, Cin, Cout, F) || B < 1)
    return (int)cudaErrorInvalidValue;
  Conv3Args a = base_args(H, W, Cin, Cout);
  a.x = static_cast<const int8_t*>(x);
  a.bias = static_cast<const int*>(bias_rt);
  a.out = static_cast<int8_t*>(out);
  a.B = B;
  a.epi = make_epi(acc_shift, out_shift, slope_num, nearest != 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (short_shift(acc_shift) && short_shift(out_shift))
    return dispatch<true, F>(a, wp, nullptr, st);
  return dispatch<false, F>(a, wp, nullptr, st);
}

// The per-column (C = column; all three forms) and counting (C = count;
// the conv and pooled forms) forms: the
// accumulator shift of each output column from the table `shifts`; the
// short shift form where every entry and out_shift lie in [0, 31]
// (short_cols: the entries, checked by the caller), never when counting.
template <Form F, Cols C>
int run_cols(const void* x, const void* wp, const void* bias_rt,
             const void* shifts, void* out, void* overflow, int B, int H,
             int W, int Cin, int Cout, int short_cols, int out_shift,
             int slope_num, int nearest, void* stream) {
  if (bad_shape(H, W, Cin, Cout, F) || B < 1 || shifts == nullptr ||
      (C == Cols::count) != (overflow != nullptr))
    return (int)cudaErrorInvalidValue;
  Conv3Args a = base_args(H, W, Cin, Cout);
  a.x = static_cast<const int8_t*>(x);
  a.bias = static_cast<const int*>(bias_rt);
  a.out = static_cast<int8_t*>(out);
  a.B = B;
  a.epi = make_epi(0, out_shift, slope_num, nearest != 0);
  a.shifts = static_cast<const int*>(shifts);
  a.overflow = static_cast<int*>(overflow);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (C == Cols::column)
    if (short_cols && short_shift(out_shift))
      return dispatch<true, F, C>(a, wp, nullptr, st);
  return dispatch<false, F, C>(a, wp, nullptr, st);
}

// the layout of a batch of B (the slab walk's groups depend on it)
template <Form F>
int layout(int B, int H, int W, int Cin, int Cout, int* out) {
  if (bad_shape(H, W, Cin, Cout, F) || B < 1)
    return (int)cudaErrorInvalidValue;
  Conv3Args a = base_args(H, W, Cin, Cout);
  a.B = B;
  return dispatch<true, F>(a, nullptr, out, nullptr);
}

// The two-part form: the 128-column tile where Cout fills it and the
// parts take one shift, else the 64-column one (a split's second
// accumulator fits there only); on its slab walk where slab_walk takes
// the conv.
template <bool SHORT, Cols C>
int dispatch_parts(const Conv3PartsArgs& a, const void* wp, int* info,
                   cudaStream_t st) {
  if (slab_walk(a.CK, a.Cin0)) {
    if (a.Cout % 128 == 0 && !a.split)
      return launch_form<128, SHORT, Form::conv, C, true, true>(a, wp, info,
                                                                st);
    return launch_form<64, SHORT, Form::conv, C, true, true>(a, wp, info, st);
  }
  if (a.Cout % 128 == 0 && !a.split)
    return launch_form<128, SHORT, Form::conv, C, true>(a, wp, info, st);
  return launch_form<64, SHORT, Form::conv, C, true>(a, wp, info, st);
}

bool bad_parts(int H, int W, int Cin0, int Cin1, int Cout) {
  return H < 1 || W < 1 || Cout < 1 || Cin0 < 32 || Cin0 % 32 ||
         Cin1 < 32 || Cin1 % 32;
}

// the two-part form's arguments but its shifts: Cin and CK both parts'
// channels (the halo tile's)
Conv3PartsArgs parts_args(const void* x0, const void* x1,
                          const void* bias_rt, void* out, int B, int H,
                          int W, int Cin0, int Cin1, int Cout, bool split) {
  Conv3PartsArgs a{};
  static_cast<Conv3Args&>(a) = base_args(H, W, Cin0 + Cin1, Cout);
  a.x = static_cast<const int8_t*>(x0);
  a.x1 = static_cast<const int8_t*>(x1);
  a.bias = static_cast<const int*>(bias_rt);
  a.out = static_cast<int8_t*>(out);
  a.B = B;
  a.Cin0 = Cin0;
  a.split = split;
  return a;
}

}  // namespace

extern "C" {

// x: int8 NHWC [B, H, W, Cin], Cin % 32 == 0; wp: int8 [Cout, 9 * Cin] in
// (dy, dx, c) order; bias_rt: int32 [Cout rounded up to 128] at the retune
// scale, zero past Cout; out: int8 [B, H, W, Cout]; x, wp and out 16-byte
// aligned; B * H * W < 2^31. acc_shift brings the accumulator to the
// retune scale, out_shift the activation to the output scale; slope_num:
// the LeakyReLU slope * 65536 (8192: 0.125; 65536: none). The kernel picks
// its walk and output tile (plan, or plan_tile_slabs where slab_walk takes
// the conv; reported by yolo_int8_conv3x3_wgmma_info) and fails where no
// tile fits. Returns the first CUDA error of setting up or launching.
int yolo_int8_conv3x3_wgmma(const void* x, const void* wp,
                            const void* bias_rt, void* out, int B, int H,
                            int W, int Cin, int Cout, int acc_shift,
                            int out_shift, int slope_num, int nearest,
                            void* stream) {
  return run<Form::conv>(x, wp, bias_rt, out, B, H, W, Cin, Cout,
                         acc_shift, out_shift, slope_num, nearest, stream);
}

// The pooled form, conv3x3 + 2x2/2 max pool: as yolo_int8_conv3x3_wgmma,
// with H and W even, Cin % 32 == 0 or Cin == 16, wp int8 [Cout, 9 * CK]
// (CK = Cin rounded up to 32, zero past Cin) and out int8 [B, H / 2,
// W / 2, Cout]; its layout: yolo_int8_conv3x3_pool_wgmma_info.
int yolo_int8_conv3x3_pool_wgmma(const void* x, const void* wp,
                                 const void* bias_rt, void* out, int B,
                                 int H, int W, int Cin, int Cout,
                                 int acc_shift, int out_shift, int slope_num,
                                 int nearest, void* stream) {
  return run<Form::pool>(x, wp, bias_rt, out, B, H, W, Cin, Cout,
                         acc_shift, out_shift, slope_num, nearest, stream);
}

// The stride-2 form, conv3x3 with stride 2 and pad 1: as
// yolo_int8_conv3x3_wgmma, with out int8 [B, (H + 1) / 2, (W + 1) / 2,
// Cout] (H and W odd or even); its layout:
// yolo_int8_conv3x3_s2_wgmma_info.
int yolo_int8_conv3x3_s2_wgmma(const void* x, const void* wp,
                               const void* bias_rt, void* out, int B, int H,
                               int W, int Cin, int Cout, int acc_shift,
                               int out_shift, int slope_num, int nearest,
                               void* stream) {
  return run<Form::s2>(x, wp, bias_rt, out, B, H, W, Cin, Cout, acc_shift,
                       out_shift, slope_num, nearest, stream);
}

// The conv with one accumulator shift per output column (a per-channel
// sw): as yolo_int8_conv3x3_wgmma, with shifts: int32 [Cout rounded up to
// 128], each column's shift as _shift reads it (int8_conv.py's
// acc_shift_table), 0 past Cout, 8-byte aligned; short_cols: every entry
// in [0, 31].
int yolo_int8_conv3x3_cols_wgmma(const void* x, const void* wp,
                                 const void* bias_rt, const void* shifts,
                                 void* out, int B, int H, int W, int Cin,
                                 int Cout, int short_cols, int out_shift,
                                 int slope_num, int nearest, void* stream) {
  return run_cols<Form::conv, Cols::column>(
      x, wp, bias_rt, shifts, out, nullptr, B, H, W, Cin, Cout, short_cols,
      out_shift, slope_num, nearest, stream);
}

// The same for the pooled form.
int yolo_int8_conv3x3_pool_cols_wgmma(const void* x, const void* wp,
                                      const void* bias_rt,
                                      const void* shifts, void* out, int B,
                                      int H, int W, int Cin, int Cout,
                                      int short_cols, int out_shift,
                                      int slope_num, int nearest,
                                      void* stream) {
  return run_cols<Form::pool, Cols::column>(
      x, wp, bias_rt, shifts, out, nullptr, B, H, W, Cin, Cout, short_cols,
      out_shift, slope_num, nearest, stream);
}

// The same for the stride-2 form.
int yolo_int8_conv3x3_s2_cols_wgmma(const void* x, const void* wp,
                                    const void* bias_rt, const void* shifts,
                                    void* out, int B, int H, int W, int Cin,
                                    int Cout, int short_cols, int out_shift,
                                    int slope_num, int nearest,
                                    void* stream) {
  return run_cols<Form::s2, Cols::column>(
      x, wp, bias_rt, shifts, out, nullptr, B, H, W, Cin, Cout, short_cols,
      out_shift, slope_num, nearest, stream);
}

// The conv with per-column shifts (as yolo_int8_conv3x3_cols_wgmma) that
// also adds to *overflow (int32) how many of its outputs, after the
// accumulator shift and the bias, lie outside int16 (the values the
// requant clamps).
int yolo_int8_conv3x3_count_wgmma(const void* x, const void* wp,
                                  const void* bias_rt, const void* shifts,
                                  void* out, void* overflow, int B, int H,
                                  int W, int Cin, int Cout, int out_shift,
                                  int slope_num, int nearest, void* stream) {
  return run_cols<Form::conv, Cols::count>(
      x, wp, bias_rt, shifts, out, overflow, B, H, W, Cin, Cout, 0,
      out_shift, slope_num, nearest, stream);
}

// The same for the pooled form, which counts all four values of each 2x2
// window, before the pool.
int yolo_int8_conv3x3_pool_count_wgmma(const void* x, const void* wp,
                                       const void* bias_rt,
                                       const void* shifts, void* out,
                                       void* overflow, int B, int H, int W,
                                       int Cin, int Cout, int out_shift,
                                       int slope_num, int nearest,
                                       void* stream) {
  return run_cols<Form::pool, Cols::count>(
      x, wp, bias_rt, shifts, out, overflow, B, H, W, Cin, Cout, 0,
      out_shift, slope_num, nearest, stream);
}

// The two-part form, conv3x3 (stride 1, pad 1) over the channel concat of
// x0: int8 NHWC [B, H, W, Cin0] and x1: [B, H, W, Cin1], each Cin % 32 ==
// 0, each part at its own scale: wp int8 [Cout, 9 * Cin0 + 9 * Cin1],
// part 0's (dy, dx, c) block and then part 1's
// (pack_conv3x3_parts_weights); bias_rt as yolo_int8_conv3x3_wgmma's; out
// int8 [B, H, W, Cout]. acc_shift0 / acc_shift1 bring each part's
// accumulator to the retune scale: where they agree the raw partials are
// summed before the one shift (the conv over the concat), else each
// part's partial is shifted on its own and the two summed
// (fixed_point.int_conv_requant's groups). Its layout:
// yolo_int8_conv3x3_parts_wgmma_info.
int yolo_int8_conv3x3_parts_wgmma(const void* x0, const void* x1,
                                  const void* wp, const void* bias_rt,
                                  void* out, int B, int H, int W, int Cin0,
                                  int Cin1, int Cout, int acc_shift0,
                                  int acc_shift1, int out_shift,
                                  int slope_num, int nearest, void* stream) {
  if (bad_parts(H, W, Cin0, Cin1, Cout) || B < 1)
    return (int)cudaErrorInvalidValue;
  Conv3PartsArgs a = parts_args(x0, x1, bias_rt, out, B, H, W, Cin0, Cin1,
                                Cout, acc_shift0 != acc_shift1);
  a.sh0 = make_shift(acc_shift0, nearest != 0);
  a.epi = make_epi(acc_shift1, out_shift, slope_num, nearest != 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (short_shift(acc_shift0) && short_shift(acc_shift1) &&
      short_shift(out_shift))
    return dispatch_parts<true, Cols::scalar>(a, wp, nullptr, st);
  return dispatch_parts<false, Cols::scalar>(a, wp, nullptr, st);
}

// The two-part form with one accumulator shift per output column (a
// per-channel sw): as yolo_int8_conv3x3_parts_wgmma, with each column's
// shift from a table (int32 [Cout rounded up to 128], int8_conv.py's
// acc_shift_table, 0 past Cout, 8-byte aligned) in place of acc_shift0 /
// acc_shift1: with split != 0 (parts of two input scales) shifts0 is part
// 0's table and shifts1 part 1's, else shifts1 is both parts' (shifts0
// unused); short_cols: every entry of the tables in [0, 31].
int yolo_int8_conv3x3_parts_cols_wgmma(
    const void* x0, const void* x1, const void* wp, const void* bias_rt,
    const void* shifts0, const void* shifts1, void* out, int B, int H, int W,
    int Cin0, int Cin1, int Cout, int split, int short_cols, int out_shift,
    int slope_num, int nearest, void* stream) {
  if (bad_parts(H, W, Cin0, Cin1, Cout) || B < 1 || shifts1 == nullptr ||
      (split && shifts0 == nullptr))
    return (int)cudaErrorInvalidValue;
  Conv3PartsArgs a = parts_args(x0, x1, bias_rt, out, B, H, W, Cin0, Cin1,
                                Cout, split != 0);
  a.epi = make_epi(0, out_shift, slope_num, nearest != 0);
  a.shifts = static_cast<const int*>(shifts1);
  a.shifts0 = static_cast<const int*>(shifts0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (short_cols && short_shift(out_shift))
    return dispatch_parts<true, Cols::column>(a, wp, nullptr, st);
  return dispatch_parts<false, Cols::column>(a, wp, nullptr, st);
}

// The two-part form's layout (both shift forms') for a batch of B H x W x
// (Cin0 + Cin1) -> Cout convs whose parts take two shifts (split != 0) or
// one: info[0..10] as yolo_int8_conv3x3_wgmma_info's (the halo tile's
// channels both parts', or a slab), info[11] = split. Returns 0, or an
// error code where the shape is not taken or no tile fits in shared
// memory.
int yolo_int8_conv3x3_parts_wgmma_info(int B, int H, int W, int Cin0,
                                       int Cin1, int Cout, int split,
                                       int* info_out) {
  if (bad_parts(H, W, Cin0, Cin1, Cout) || B < 1)
    return (int)cudaErrorInvalidValue;
  const Conv3PartsArgs a = parts_args(nullptr, nullptr, nullptr, nullptr, B,
                                      H, W, Cin0, Cin1, Cout, split != 0);
  const int rc = dispatch_parts<true, Cols::scalar>(a, nullptr, info_out,
                                                    nullptr);
  if (rc == 0) info_out[INFO_LEN] = split != 0;
  return rc;
}

// The kernel's layout for a batch of B H x W x Cin -> Cout convs:
// info[0..10] = tile height, tile width, dynamic shared memory bytes,
// resident blocks per SM, columns per weight tile (BN), consumer
// warpgroups, ring stages, pixels of a full tile, rows of the 64-row
// wgmma steps that a full tile runs, channels of the halo tile (Cin
// rounded up to 32, or a slab), blocks per tile (the slab walk's groups
// of weight tiles, by B; else 1). Returns 0, or an error code where the
// shape is not taken or no tile fits in shared memory.
int yolo_int8_conv3x3_wgmma_info(int B, int H, int W, int Cin, int Cout,
                                 int* info_out) {
  return layout<Form::conv>(B, H, W, Cin, Cout, info_out);
}

// The same for the pooled form (a full tile's pixels are 4 per pooled
// pixel; its 64-row steps hold 16 pooled pixels each).
int yolo_int8_conv3x3_pool_wgmma_info(int H, int W, int Cin, int Cout,
                                      int* info_out) {
  return layout<Form::pool>(1, H, W, Cin, Cout, info_out);
}

// The same for the stride-2 form, whose tile is in output pixels.
int yolo_int8_conv3x3_s2_wgmma_info(int H, int W, int Cin, int Cout,
                                    int* info_out) {
  return layout<Form::s2>(1, H, W, Cin, Cout, info_out);
}

}  // extern "C"
