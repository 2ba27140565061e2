// The two thin-input entry convs of the port, for Hopper (sm_90a), as
// row-streaming wgmma kernels. Plain C interface, loaded with ctypes by
// yolo_tpu_torch/kernels/int8_conv.py.
//
//   - entry_conv3x3_wgmma: int8 NHWC [B, H, W, Cin] conv3x3 (stride 1,
//     pad 1) + fixed-point requant -> int8 [B, H, W, Cout], 1 <= Cin <= 3,
//     Cout <= 64, with a scalar sw or a per-column shift table
//     (Cols::column: a per-channel sw) (int8_conv_requant,
//     entry_conv3x3_route: yolo_v3's C_in = 3 entry conv). It replaces
//     XLA's integer conv in
//     yolo_tpu/quant/fixed_point.py::int_conv_requant at that conv (no
//     Pallas kernel), which ran on the general conv's mma.sync loop
//     (int8_conv_general.cu, a byte gather from global memory per K byte).
//   - pool_s2d_wgmma: conv3x3 + 2x2/2 max pool + requant on the padded
//     space-to-depth input [B, H/2 + 3, W/2 + 3, 4 Cin] -> int8 [B, H/2,
//     W/2, Cout], Cin <= 4, Cout <= 32 (int8_conv3x3_pool_s2d,
//     pool_s2d_wgmma_route: slim_yolo_v2's conv1, 3 -> 16). It replaces
//     the Pallas TPU kernel K2, _pool_matmul_kernel /
//     int8_conv3x3_pool_requant(assembly='s2d') of
//     yolo_tpu/kernels/int8_conv.py, which int8_conv.cu's pool_s2d kernel
//     (mma.sync) ran before; that kernel still takes the other shapes.
//   - pool_nhwc (the same kernel's NHWC form, In::nhwc): the same conv +
//     pool + requant on int8 NHWC [B, H, W, Cin] -> int8 [B, H/2, W/2,
//     Cout], Cin <= 4, Cout <= 32 (int8_conv3x3_im2col(pool=True) and
//     int8_conv3x3_pool_requant(assembly='stride2'), pool_nhwc_wgmma_route:
//     slim's conv1 on NHWC input), with a scalar sw, a per-column shift
//     table (Cols::column: a per-channel sw) or the table and a count of
//     the values that hit the int16 clamp (Cols::count:
//     int8_forward_diagnostics, all four window values counted before the
//     max). It replaces the Pallas TPU kernel K3, _im2col_kernel /
//     int8_conv3x3_im2col(pool=True), at C_in <= 4 (and, per-channel,
//     XLA's conv + _shift + reduce_window of yolo_tpu/quant/fixed_point.py
//     at slim's conv1), which int8_conv.cu's mma.sync conv (a byte gather
//     from global memory per K byte) ran before. It is K2's GEMM with
//     another A path: the s2d layout only re-indexes a pooled pixel's 4x4
//     input window, so the A words are read from the NHWC rows in place,
//     with no s2d pass over the input.
//
// What bounds them on an H100: bytes set their least time. The entry
// conv does 18 Cin Cout ops per pixel against Cin bytes in and Cout out
// (at 416^2, 3 -> 32, batch 128: 66.4 MB in, 708.8 MB out, 0.231 ms at
// 3.35 TB/s against 0.019 ms of int8 tensor-core time); K2's GEMM does
// 2 x 48 x 64 ops per pooled pixel against 12.4 bytes in and 16 out
// (136.8 MB in, 177.2 MB out at batch 256: 0.094 ms; its NHWC form reads
// 12 bytes a pooled pixel: 132.9 MB in, 0.093 ms). Each is one K step of
// a GEMM (K = 27 -> 32; K = 16 Cin = 48 -> 64, two k32 steps), so the
// MMAs take little time and
// the kernel is its input copy, its operand assembly, its requant and its
// stores. The mma.sync kernels ran each 128-row tile as a serial chain
// (per-row global gathers, __syncthreads, MMA, __syncthreads, epilogue,
// store). Here
//   1. a block takes TH whole output rows of one image (a width chunk
//      where a row does not fit: plan_rows), whose input is TH + 2 (K2:
//      TH + 1 s2d; its NHWC form: 2 TH + 2) rows of contiguous bytes,
//      and copies each row into
//      shared memory with 16-byte cp.async of the row's 16-byte-aligned
//      superset (the chunk at the tensor's end clipped: nothing past it is
//      read). Rows sit at a pitch congruent to the global row pitch mod 16
//      and each lands co-aligned with its global address, so every chunk
//      is one aligned 16-byte copy; no 2-D TMA map (its rows need 16-byte
//      pitches: W x 3 = 1,248 at 416 is one, the s2d pitch of 2,532 is
//      not, nor are odd widths). The entry conv's padding (rows -1 and H,
//      columns -1 and W) is zeros written in shared memory after the copy
//      lands, over whatever the superset brought from a neighbouring row
//      or image. The weights (packed once per model, K-major) are copied
//      into a 128-byte-swizzled tile, as TMA would lay it out, so the B
//      descriptor is int8_wgmma.cuh's;
//   2. builds the A fragments of each 64-pixel wgmma step (RS) from
//      shared memory, never from global memory: the entry conv's pixel
//      reads 3 Cin contiguous bytes per dy (the (dy, dx, c) = HWIO order of
//      the packed K), so each thread holds the 8 byte offsets of its K
//      bytes (4 tig .. +3, 16 + 4 tig .. +3) and assembles 4 registers from
//      16 byte loads; K2's pooled pixel reads two runs of 8 Cin bytes (two
//      s2d pixels, in (block column, py, px, c) order) in rows u + 1 and
//      u + 2, so each of its registers is one aligned 32-bit load; the
//      NHWC form's pooled pixel reads four runs of 4 Cin bytes (window
//      rows dy = 0..3, K in (dy, dx, c) order) in input rows 2u - 1 ..
//      2u + 2, each a whole number of 4-byte words that Cin = 1, 2, 3
//      leave unaligned, so each register is four byte loads packed by
//      three byte permutes (on an H100 0-2% faster than two aligned
//      32-bit loads and a funnel shift);
//   3. runs one m64nNk32 wgmma per 64 pixels (K2: two), requantizes in
//      registers with the branch-free shifts of int8_wgmma_conv.cuh (Epi;
//      each pair of outputs clamped to int8 and packed by one
//      cvt.pack.sat),
//      K2 first taking each pooled value's max over the four phases on the
//      int32 accumulator (exact: the requant chain is monotone). K2's
//      columns are phase-major, column p CP + co for phase p = 2a + b of
//      the pool window and CP = Cout rounded up to 16 or 32, so a thread's
//      four phases of a channel sit in its own registers (n8 groups j,
//      j + CP/8, ...): no shuffle;
//   4. stages the int8 tile in shared memory, co-aligned with the output,
//      and stores whole output rows (contiguous spans of TW Cout bytes) as
//      16-byte stores, bytes only at each row's two ends.
// Two warpgroups per block, each taking every other 64-pixel step, and
// blocks sized so that two (the entry conv) or three (K2) reside per SM
// (plan_rows: their tile, input rows and staging fit in the block's share
// of shared memory), so one block's copies and stores overlap the others'
// MMAs and requant. Once the gathers are gone the kernels are bound by
// integer instructions, the requant chain of every output value, not by
// bytes: the entry conv writes 708.8 M values at batch 128.
//
// The shifts follow yolo_tpu/quant/fixed_point.py::_shift, including
// s >= 32 and s < 0; the slope is the Q16 numerator (8192: 0.125; 6554:
// darknet's 0.1; 65536: none); both roundings. The NHWC form's per-column
// and counting forms read the shift table of int8_conv3x3_wgmma.cu's
// (int8_conv.py's acc_shift_table), an int2 per column pair after the
// phase max; each warp adds its count with one atomic. The entry conv's
// per-column form reads its int2 of that table per column pair in the
// epilogue (on an H100 2% faster than holding the pairs in registers
// beside the bias, whose 64-column general form then spilled). The input
// layout and the shift forms are template forms:
// K2's and the entry conv's scalar instantiations are those of before.

#include <type_traits>

#include "int8_wgmma_conv.cuh"

namespace {

constexpr int THREADS = 256;  // two warpgroups
constexpr int MAX_TILE_ROWS = 16;
constexpr int MAX_TILE_PX = 2048;
constexpr int INFO_LEN = 8;

__host__ __device__ inline long long mod16(long long v) {
  return ((v % 16) + 16) % 16;
}

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Shared-memory row pitches: an input row of `bytes` bytes keeps room for
// its co-aligned start (16-31 bytes in) and the 16-byte superset around
// it; an output row of `bytes` for its co-aligned start. Each is congruent
// to the global row pitch mod 16, so one offset co-aligns every row.
inline int in_pitch(int bytes, long long gpitch) {
  return round16(bytes + 48) + (int)(gpitch & 15);
}
inline int out_pitch(int bytes, long long gpitch) {
  return round16(bytes + 16) + (int)(gpitch & 15);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The K-major weights wp [rows, KB] (KB = 32 or 64 bytes a row) as a
// [BN, KB] tile laid out as TMA lays out a 128-byte-swizzled box (row n
// at 128 n, its 16-byte chunk c at chunk c ^ (n % 8); the tile
// 1024-byte aligned), rows past `rows` zero, so desc_sw128 reads it.
template <int BN, int KB>
__device__ __forceinline__ void load_weights(unsigned char* wt,
                                             const int8_t* wp, int rows) {
  for (int e = threadIdx.x; e < BN * (KB / 16); e += blockDim.x) {
    const int n = e / (KB / 16), c = e % (KB / 16);
    cp_async16(wt + n * 128 + ((c ^ (n & 7)) << 4),
               n < rows ? wp + n * KB + 16 * c : wp, n < rows ? 16 : 0);
  }
}

// Rows r0 .. r1 - 1 of a tile's input: row r is the `len` bytes of x at
// byte g0 + r * gpitch, landing at dst + r * RP (dst == g0 and RP ==
// gpitch mod 16). One 16-byte cp.async per aligned chunk of the row's
// aligned superset; the chunk at the tensor's end reads only up to it.
__device__ __forceinline__ void copy_rows(int8_t* dst, int RP,
                                          const int8_t* x, long long x_bytes,
                                          long long g0, long long gpitch,
                                          int len, int r0, int r1) {
  const int nch = (len + 30) / 16;  // most chunks a row's superset has
  for (int e = threadIdx.x; e < (r1 - r0) * nch; e += blockDim.x) {
    const int rr = e / nch, q = e - rr * nch;
    const long long g = g0 + (long long)(r0 + rr) * gpitch;
    const long long c = (g & ~15LL) + 16LL * q;
    if (c >= g + len) continue;
    const long long left = x_bytes - c;
    cp_async16(dst + (long long)(r0 + rr) * RP + (c - g), x + c,
               left < 16 ? (int)left : 16);
  }
}

// Rows 0 .. nrows - 1 of a staged output tile: row r is `len` bytes at
// out byte g0 + r * gpitch, staged at src + r * OP (src == g0 and OP ==
// gpitch mod 16): 16-byte stores of the row's aligned chunks, bytes at
// its head and tail.
__device__ __forceinline__ void store_rows(int8_t* out, const int8_t* src,
                                           int OP, long long g0,
                                           long long gpitch, int len,
                                           int nrows) {
  const int items = 32 + len / 16;  // 16 head bytes, 16 tail, the chunks
  for (int e = threadIdx.x; e < nrows * items; e += blockDim.x) {
    const int r = e / items, q = e - r * items;
    const long long g = g0 + (long long)r * gpitch, gend = g + len;
    const long long a0 = (g + 15) & ~15LL, a1 = gend & ~15LL;
    const int8_t* s = src + (long long)r * OP;  // the staged byte of g
    if (q < 16) {
      if (g + q < min(a0, gend)) out[g + q] = s[q];
    } else if (q < 32) {
      const long long at = a1 + (q - 16);
      if (at >= a0 && at < gend) out[at] = s[at - g];
    } else {
      const long long at = a0 + 16LL * (q - 32);
      if (at + 16 <= a1)
        *reinterpret_cast<uint4*>(out + at) =
            *reinterpret_cast<const uint4*>(s + (at - g));
    }
  }
}

// The first 1024-byte-aligned byte of the block's dynamic shared memory,
// by pointer arithmetic on the __shared__ array (an integer round trip
// would make every access through it a generic one: on an H100 each
// fragment byte then re-derived the shared window in SASS)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// (y, x) of tile pixel p in a tile tw pixels wide, by m = 2^32 / tw
// rounded up (recip; exact while p * tw < 2^32; tw = 1 has no 32-bit m)
__device__ __forceinline__ unsigned recip(int tw) {
  return 0xFFFFFFFFu / (unsigned)tw + 1;
}
__device__ __forceinline__ int2 pixel_yx(int p, int tw, unsigned m) {
  const int y = tw == 1 ? p : (int)__umulhi((unsigned)p, m);
  return make_int2(y, p - y * tw);
}

// the tile of block `blk` on an OH x OW output grid of TH x TW tiles
struct Tile {
  int b, y0, x0, th, tw;
};

__device__ __forceinline__ Tile tile_of(int blk, int OH, int OW, int TH,
                                        int TW) {
  const int ntx = (OW + TW - 1) / TW, nty = (OH + TH - 1) / TH;
  Tile t;
  t.b = blk / (ntx * nty);
  const int i = blk - t.b * ntx * nty;
  t.y0 = (i / ntx) * TH;
  t.x0 = (i % ntx) * TW;
  t.th = min(TH, OH - t.y0);
  t.tw = min(TW, OW - t.x0);
  return t;
}

// Steps s = first, first + stride, ... < steps of one warpgroup, one at a
// time: load(s, A) fills the A registers from shared memory, mma(D, A)
// zeroes D and issues D = A x B, epi(D, s) requantizes and stages step s.
// On an H100 neither more overlap helped (PERF.md, section 6): a two-deep
// form (the next step's loads and MMA issued before this step's requant,
// its accumulators kept across it) ran 22% slower on the entry conv and 5%
// on K2, and two steps' MMAs under one wait 26% slower on the entry conv
// (K2's form then spilled).
template <int NA, int ND, class Load, class Mma, class Epil>
__device__ __forceinline__ void run_steps(int first, int stride, int steps,
                                          Load load, Mma mma, Epil epi) {
  for (int s = first; s < steps; s += stride) {
    unsigned af[NA];
    int d[ND];
    load(s, af);
    mma(d, af);
    wgmma_commit();
    wgmma_wait<0>();
    epi(d, s);
  }
}

// Stages a pair of requantized columns at o: one 2-byte store of both
// (clamped and packed by cvt.pack.sat) where Cout is even, else bytes
// masked at Cout.
template <bool SHORT>
__device__ __forceinline__ void stage2(int8_t* o, int col, int Cout,
                                       const Epi& epi, int v0, int v1,
                                       int2 bias) {
  if (Cout % 2 == 0) {
    *reinterpret_cast<uint16_t*>(o + col) =
        pack_sat2(epi.unclamped<SHORT>(v0, bias.x),
                  epi.unclamped<SHORT>(v1, bias.y));
  } else {
    o[col] = epi.apply<SHORT>(v0, bias.x);
    if (col + 1 < Cout) o[col + 1] = epi.apply<SHORT>(v1, bias.y);
  }
}

// The same with each column's own accumulator shift (a per-channel sw).
template <bool SHORT>
__device__ __forceinline__ void stage2(int8_t* o, int col, int Cout,
                                       const Epi& epi, const Shift& s0,
                                       const Shift& s1, int v0, int v1,
                                       int2 bias) {
  if (Cout % 2 == 0) {
    *reinterpret_cast<uint16_t*>(o + col) =
        pack_sat2(epi.rest<SHORT>(s0.apply<SHORT>(v0), bias.x),
                  epi.rest<SHORT>(s1.apply<SHORT>(v1), bias.y));
  } else {
    o[col] = epi.apply<SHORT>(s0, v0, bias.x);
    if (col + 1 < Cout) o[col + 1] = epi.apply<SHORT>(s1, v1, bias.y);
  }
}

// Where a row-streaming tile's NHWC input lands in shared memory (the
// NHWC form of K2; the entry conv keeps its own inline copy of these
// steps, whose SASS moved when it called them): an
// H x W x C image's rows iy0 - 1 .. iy0 + ith (r = 0 .. ith + 1) and
// columns ix0 - 1 .. ix0 + itw (pixel i = 0 .. itw + 1) of image b, row r
// of pixel i at ia + r * RP + i * C, co-aligned with its global byte.
// Rows r0 .. r1 - 1 and columns xs .. xe (pixel is ..) lie in the image;
// the rest is the conv's zero padding.
struct InRows {
  long long g0, gp;  // global byte of (row 0, column xs); row pitch
  int ia, is, xs, xe, r0, r1;
};

__device__ __forceinline__ InRows in_rows_of(int b, int iy0, int ix0,
                                             int ith, int itw, int H, int W,
                                             int C) {
  InRows r;
  r.gp = (long long)W * C;
  r.xs = max(ix0 - 1, 0);
  r.xe = min(ix0 + itw, W - 1);
  r.is = r.xs - ix0 + 1;
  r.g0 = ((long long)b * H + iy0 - 1) * r.gp + (long long)r.xs * C;
  r.ia = 16 + (int)mod16(r.g0 - (long long)r.is * C);
  r.r0 = iy0 == 0 ? 1 : 0;
  r.r1 = min(ith + 2, H - iy0 + 1);
  return r;
}

// The padding of those rows (xb: their pixel 0 of row 0), once the copy
// has landed: rows outside the image, columns -1 and W, zero
__device__ __forceinline__ void zero_padding(int8_t* xb, int RP,
                                             const InRows& r, int ix0,
                                             int ith, int itw, int W, int C) {
  const int tid = threadIdx.x;
  for (int y = 0; y < ith + 2; ++y) {
    int8_t* row = xb + y * RP;
    if (y < r.r0 || y >= r.r1) {
      for (int k = tid; k < (itw + 2) * C; k += THREADS) row[k] = 0;
    } else if (tid < C) {
      if (ix0 == 0) row[tid] = 0;
      if (ix0 + itw == W) row[(itw + 1) * C + tid] = 0;
    }
  }
}

// the accumulator shifts: one for the layer (Epi's), one per output column
// from a shift table (a per-channel sw), or per column counting the values
// that reach the int16 clamp (int8_forward_diagnostics; the general shift
// form only); the entry conv and K2's NHWC form take a table, only the
// latter counts
enum class Cols { scalar, column, count };

// ---------------------------------------------------------------------------
// The entry conv: 3x3, stride 1, pad 1, Cin <= 3.
// ---------------------------------------------------------------------------

struct EntryArgs {
  const int8_t* x;   // [B, H, W, Cin]
  const int8_t* wp;  // [Cout, 32]: (dy, dx, c) order, zero past 9 Cin
  const int* bias;   // [BN] at the retune scale, zero past Cout
  int8_t* out;       // [B, H, W, Cout]
  long long x_bytes;
  int B, H, W, Cin, Cout;
  int TH, TW, RP, OP;  // tile, shared input / output row pitches
  Epi epi;
};

// the per-column form's arguments: the accumulator shift table ([>= 64],
// 0 past Cout; a separate type, so that the scalar forms' arguments stay
// those of before, as ColsArgs below)
struct EntryColsArgs : EntryArgs {
  const int* shifts;
};

template <Cols C>
using EntryArgsOf =
    std::conditional_t<C == Cols::scalar, EntryArgs, EntryColsArgs>;

// blocks per SM each form is built for: two (128 registers a thread; on
// an H100 the entry conv ran 12% slower at four blocks of 64 registers and
// 7% at three, PERF.md, section 6)
template <int BN>
struct EntryCfg {
  static constexpr int BLOCKS = 2;
};

// (CF: the shift form; C below is Cin)
template <int BN, bool SHORT, Cols CF>
__global__ void __launch_bounds__(THREADS, EntryCfg<BN>::BLOCKS)
    entry_conv3x3_wgmma(const EntryArgsOf<CF> a) {
  static_assert(CF != Cols::count, "the entry conv counts no overflow");
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* wt = align1024(dsmem);
  int8_t* xin = reinterpret_cast<int8_t*>(wt + BN * 128);
  int8_t* ost = xin + round16((a.TH + 2) * a.RP);
  const int tid = threadIdx.x, C = a.Cin;
  const Tile t = tile_of(blockIdx.x, a.H, a.W, a.TH, a.TW);

  // ---- 1. input rows r = 0 .. th + 1 (image rows y0 - 1 + r): pixel i
  // (column x0 - 1 + i) at xin + ia + r * RP + i * C, co-aligned with x
  const long long gp = (long long)a.W * C;  // bytes between image rows
  const int xs = max(t.x0 - 1, 0), xe = min(t.x0 + t.tw, a.W - 1);
  const int is = xs - t.x0 + 1;  // pixel of column xs
  const long long g0 =
      ((long long)t.b * a.H + t.y0 - 1) * gp + (long long)xs * C;
  const int ia = 16 + (int)mod16(g0 - (long long)is * C);
  // the rows inside the image
  const int r0 = t.y0 == 0 ? 1 : 0, r1 = min(t.th + 2, a.H - t.y0 + 1);
  load_weights<BN, 32>(wt, a.wp, a.Cout);
  copy_rows(xin + ia + is * C, a.RP, a.x, a.x_bytes, g0, gp,
            (xe - xs + 1) * C, r0, r1);
  cp_async_wait_all();
  fence_proxy_async();  // the weight tile is read by wgmma (async proxy)
  __syncthreads();
  // the padding: rows outside the image, columns -1 and W, zero
  for (int r = 0; r < t.th + 2; ++r) {
    int8_t* row = xin + ia + r * a.RP;
    if (r < r0 || r >= r1) {
      for (int k = tid; k < (t.tw + 2) * C; k += THREADS) row[k] = 0;
    } else if (tid < C) {
      if (t.x0 == 0) row[tid] = 0;
      if (t.x0 + t.tw == a.W) row[(t.tw + 1) * C + tid] = 0;
    }
  }
  __syncthreads();

  // ---- 2. the K bytes of this thread's A registers: k = 4 tig + e and
  // 16 + 4 tig + e, at row dy = k / 3C, byte k % 3C of the pixel's run
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // (bytes past 9C read the pixel's first byte and are masked off)
  int off[8];
  unsigned mask[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = (e < 4 ? 0 : 16) + 4 * tig + (e & 3);
    off[e] = k < 9 * C ? k / (3 * C) * a.RP + k % (3 * C) : 0;
    if (k < 9 * C) mask[e >> 2] |= 0xFFu << (8 * (e & 3));
  }
  const auto word = [=](const int8_t* px, int w) {
    unsigned v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v |= (unsigned)(uint8_t)px[off[4 * w + e]] << (8 * e);
    return v & mask[w];
  };
  // this thread's bias pairs, columns 8 j + 2 tig (+1)
  int2 bias[BN / 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    bias[j] = *reinterpret_cast<const int2*>(a.bias + 8 * j + 2 * tig);

  // ---- 3. one m64nBNk32 per 64 pixels of the tile, requant, stage
  const long long go =
      (((long long)t.b * a.H + t.y0) * a.W + t.x0) * a.Cout;
  int8_t* ob = ost + mod16(go);  // staged output row 0, co-aligned
  const int npx = t.th * t.tw, steps = (npx + 63) / 64;
  const unsigned rcp = recip(t.tw);
  const uint64_t db = desc_sw128(wt);
  const int8_t* xb = xin + ia;
  const int row0 = warp * 16 + gid;  // this thread's first row of a step
  const auto load = [=](int s, unsigned (&af)[4]) {
    const int8_t* px[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = s * 64 + row0 + 8 * h;
      const int2 yx = pixel_yx(q < npx ? q : 0, t.tw, rcp);
      px[h] = xb + yx.x * a.RP + yx.y * C;
    }
    af[0] = word(px[0], 0);
    af[1] = word(px[1], 0);
    af[2] = word(px[0], 1);
    af[3] = word(px[1], 1);
  };
  const auto mma = [=](int (&d)[BN / 2], const unsigned (&af)[4]) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) d[e] = 0;
    wgmma_fence();
    mma_rs<BN>(d, af, db);
  };
  const auto epi = [=](const int (&d)[BN / 2], int s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = s * 64 + row0 + 8 * h;
      if (q < npx) {
        const int2 yx = pixel_yx(q, t.tw, rcp);
        int8_t* o = ob + yx.x * a.OP + yx.y * a.Cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          if (8 * j + 2 * tig < a.Cout) {
            if constexpr (CF == Cols::scalar) {
              stage2<SHORT>(o, 8 * j + 2 * tig, a.Cout, a.epi,
                            d[4 * j + 2 * h], d[4 * j + 2 * h + 1], bias[j]);
            } else {
              const bool nearest = a.epi.rnd != 0;
              const int2 sc = __ldg(reinterpret_cast<const int2*>(
                  a.shifts + 8 * j + 2 * tig));
              stage2<SHORT>(o, 8 * j + 2 * tig, a.Cout, a.epi,
                            column_shift<SHORT>(sc.x, nearest),
                            column_shift<SHORT>(sc.y, nearest),
                            d[4 * j + 2 * h], d[4 * j + 2 * h + 1],
                            bias[j]);
            }
          }
      }
    }
  };
  run_steps<4, BN / 2>(wg, 2, steps, load, mma, epi);
  __syncthreads();
  // ---- 4. whole output rows
  store_rows(a.out, ob, a.OP, go, (long long)a.W * a.Cout, t.tw * a.Cout,
             t.th);
}

// ---------------------------------------------------------------------------
// K2: conv3x3 + 2x2 pool, Cin <= 4, Cout <= 32, on the padded s2d layout
// or (its NHWC form) on NHWC rows.
// ---------------------------------------------------------------------------

// the input: the padded s2d layout, or NHWC rows read in place
enum class In { s2d, nhwc };

struct PoolArgs {
  const int8_t* x;   // s2d: [B, Ho + 3, Wo + 3, 4 Cin]; NHWC: [B, H, W, Cin]
  const int8_t* wp;  // [4 CP, 64]: row p CP + co; K (r, s, py, px, c) of
                     // the s2d window, or (dy, dx, c) of the NHWC one
  const int* bias;   // [CP] at the retune scale, zero past Cout
  int8_t* out;       // [B, Ho, Wo, Cout]
  long long x_bytes;
  int B, Ho, Wo, Cin, Cout;
  int TH, TW, RP, OP;
  Epi epi;
};

// the per-column and counting forms' arguments: the accumulator shift
// table ([>= 32], 0 past Cout), and with count the int32 the warps' counts
// are added to (a separate type: a larger PoolArgs changed K2's SASS)
struct ColsArgs : PoolArgs {
  const int* shifts;
  int* overflow;
};

template <Cols C>
using PoolArgsOf =
    std::conditional_t<C == Cols::scalar, PoolArgs, ColsArgs>;

template <int BN>
struct PoolCfg {
  static constexpr int CP = BN / 4;  // columns of one pool phase
  static constexpr int BLOCKS = BN == 64 ? 3 : 2;
};

template <int BN, bool SHORT, In IN, Cols C>
__global__ void __launch_bounds__(THREADS, PoolCfg<BN>::BLOCKS)
    pool_wgmma(const PoolArgsOf<C> a) {
  constexpr int CP = PoolCfg<BN>::CP;
  constexpr bool NHWC = IN == In::nhwc, COUNT = C == Cols::count;
  static_assert(NHWC || C == Cols::scalar, "the s2d layout takes one shift");
  static_assert(!COUNT || !SHORT, "counting takes the general shifts");
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* wt = align1024(dsmem);
  int8_t* xin = reinterpret_cast<int8_t*>(wt + BN * 128);
  int8_t* ost = xin + round16((NHWC ? 2 * a.TH + 2 : a.TH + 1) * a.RP);
  const int tid = threadIdx.x, C4 = 4 * a.Cin;  // bytes of an s2d pixel
  const Tile t = tile_of(blockIdx.x, a.Ho, a.Wo, a.TH, a.TW);

  int8_t* xb;  // pooled pixel (u, v)'s window: xb + 2u RP + 2v Cin (NHWC)
  if constexpr (NHWC) {
    // ---- 1. input rows 2 u0 - 1 + r, r = 0 .. 2 th + 1, columns 2 v0 -
    // 1 .. 2 (v0 + tw): pooled pixel (u, v) reads rows 2u - 1 .. 2u + 2 at
    // columns 2v - 1 .. 2v + 2, the padding zero
    const InRows rows = in_rows_of(t.b, 2 * t.y0, 2 * t.x0, 2 * t.th,
                                   2 * t.tw, 2 * a.Ho, 2 * a.Wo, a.Cin);
    xb = xin + rows.ia;
    load_weights<BN, 64>(wt, a.wp, BN);
    copy_rows(xb + rows.is * a.Cin, a.RP, a.x, a.x_bytes, rows.g0, rows.gp,
              (rows.xe - rows.xs + 1) * a.Cin, rows.r0, rows.r1);
    cp_async_wait_all();
    fence_proxy_async();  // the weight tile is read by wgmma (async proxy)
    __syncthreads();
    zero_padding(xb, a.RP, rows, 2 * t.x0, 2 * t.th, 2 * t.tw, 2 * a.Wo,
                 a.Cin);
    __syncthreads();
  } else {
    // ---- 1. s2d rows u0 + 1 + r, r = 0 .. th, columns v0 + 1 .. v0 + tw
    // + 1: pooled pixel (u, v) reads rows u + 1, u + 2 at columns v + 1,
    // v + 2 (all inside the padded layout)
    const long long gp = (long long)(a.Wo + 3) * C4;
    const long long g0 = ((long long)t.b * (a.Ho + 3) + t.y0 + 1) * gp +
                         (long long)(t.x0 + 1) * C4;
    xb = xin + 16 + mod16(g0);
    load_weights<BN, 64>(wt, a.wp, BN);
    copy_rows(xb, a.RP, a.x, a.x_bytes, g0, gp, (t.tw + 1) * C4, 0,
              t.th + 1);
    cp_async_wait_all();
    fence_proxy_async();  // the weight tile is read by wgmma (async proxy)
    __syncthreads();
  }

  // ---- 2. this thread's A registers: K words tig + 4 e (k = 4 word), in
  // window row r = k / RUN at byte k % RUN of the row's run (s2d: two
  // s2d pixels, RUN = 8 Cin; NHWC: four pixels, RUN = 4 Cin); words past
  // 16 Cin are zero (so are their weights)
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int run = NHWC ? C4 : 2 * C4;
  // (words past 16 Cin read the pixel's first word and are masked off)
  int off[4];
  unsigned mask[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = 4 * (tig + 4 * e);
    off[e] = k < 4 * C4 ? k / run * a.RP + k % run : 0;
    mask[e] = k < 4 * C4 ? ~0u : 0u;
  }
  const auto word = [=](const int8_t* px, int e) {
    if constexpr (NHWC) {
      // the word at px + off[e], which Cin = 1, 2, 3 leave unaligned: its
      // four bytes, packed by byte permutes (on an H100 as fast as two
      // aligned loads and a funnel shift, PERF.md, section 6)
      const uint8_t* p = reinterpret_cast<const uint8_t*>(px + off[e]);
      const unsigned lo = __byte_perm(p[0], p[1], 0x0040);
      const unsigned hi = __byte_perm(p[2], p[3], 0x0040);
      return __byte_perm(lo, hi, 0x5410) & mask[e];
    } else {
      return *reinterpret_cast<const unsigned*>(px + off[e]) & mask[e];
    }
  };
  // this thread's bias pairs, channels 8 jj + 2 tig (+1)
  int2 bias[CP / 8];
#pragma unroll
  for (int jj = 0; jj < CP / 8; ++jj)
    bias[jj] = *reinterpret_cast<const int2*>(a.bias + 8 * jj + 2 * tig);

  // ---- 3. two m64nBNk32 per 64 pooled pixels (one where Cin <= 2), the
  // phase max, requant, stage
  const long long go =
      (((long long)t.b * a.Ho + t.y0) * a.Wo + t.x0) * a.Cout;
  int8_t* ob = ost + mod16(go);
  const int npx = t.th * t.tw, steps = (npx + 63) / 64;
  const unsigned rcp = recip(t.tw);
  const uint64_t db = desc_sw128(wt);
  const int row0 = warp * 16 + gid;  // this thread's first row of a step
  // A registers: the first K step's four, then the second's
  const auto load = [=](int s, unsigned (&af)[8]) {
    const int8_t* px[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = s * 64 + row0 + 8 * h;
      const int2 yx = pixel_yx(q < npx ? q : 0, t.tw, rcp);
      px[h] = NHWC ? xb + 2 * yx.x * a.RP + 2 * yx.y * a.Cin
                   : xb + yx.x * a.RP + yx.y * C4;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      af[4 * k] = word(px[0], 2 * k);
      af[4 * k + 1] = word(px[1], 2 * k);
      af[4 * k + 2] = word(px[0], 2 * k + 1);
      af[4 * k + 3] = word(px[1], 2 * k + 1);
    }
  };
  const auto mma = [=](int (&d)[BN / 2], const unsigned (&af)[8]) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) d[e] = 0;
    const unsigned k0[4] = {af[0], af[1], af[2], af[3]};
    const unsigned k1[4] = {af[4], af[5], af[6], af[7]};
    wgmma_fence();
    mma_rs<BN>(d, k0, db);
    if (a.Cin > 2) mma_rs<BN>(d, k1, db + (32 >> 4));
  };
  // (Cols::count: returns this thread's values outside int16 in step s)
  const auto epi = [=](const int (&d)[BN / 2], int s) {
    [[maybe_unused]] int n = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = s * 64 + row0 + 8 * h;
      if (q < npx) {
        const int2 yx = pixel_yx(q, t.tw, rcp);
        int8_t* o = ob + yx.x * a.OP + yx.y * a.Cout;
#pragma unroll
        for (int jj = 0; jj < CP / 8; ++jj) {
          const int co = 8 * jj + 2 * tig;
          if (co < a.Cout) {
            int v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int* m = &d[4 * jj + 2 * h + e];
              v[e] = max(max(m[0], m[4 * (CP / 8)]),
                         max(m[8 * (CP / 8)], m[12 * (CP / 8)]));
            }
            if constexpr (C == Cols::scalar) {
              stage2<SHORT>(o, co, a.Cout, a.epi, v[0], v[1], bias[jj]);
            } else {
              // this column pair's shifts, through the read-only cache
              const bool nearest = a.epi.rnd != 0;
              const int2 sc =
                  __ldg(reinterpret_cast<const int2*>(a.shifts + co));
              const Shift s0 = column_shift<SHORT>(sc.x, nearest);
              const Shift s1 = column_shift<SHORT>(sc.y, nearest);
              if constexpr (COUNT) {
                // the four phases' values of both columns, before the max
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                  const int* m = &d[4 * jj + 2 * h + 4 * (CP / 8) * p];
                  n += out_of_int16((int)((unsigned)s0.apply<false>(m[0]) +
                                          (unsigned)bias[jj].x)) +
                       out_of_int16((int)((unsigned)s1.apply<false>(m[1]) +
                                          (unsigned)bias[jj].y));
                }
              }
              stage2<SHORT>(o, co, a.Cout, a.epi, s0, s1, v[0], v[1],
                            bias[jj]);
            }
          }
        }
      }
    }
    if constexpr (COUNT) return n;
  };
  if constexpr (COUNT) {
    int cnt = 0;
    run_steps<8, BN / 2>(wg, 2, steps, load, mma,
                         [&](const int (&d)[BN / 2], int s) {
                           cnt += epi(d, s);
                         });
    // one atomic per warp
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0 && cnt != 0) atomicAdd(a.overflow, cnt);
  } else {
    run_steps<8, BN / 2>(wg, 2, steps, load, mma, epi);
  }
  __syncthreads();
  // ---- 4. whole pooled output rows
  store_rows(a.out, ob, a.OP, go, (long long)a.Wo * a.Cout, t.tw * a.Cout,
             t.th);
}

// ---------------------------------------------------------------------------
// Host: the tile plan, launch and layout report.
// ---------------------------------------------------------------------------

struct RowPlan {
  int th, tw, rp, op, smem;  // smem 0: no tile fits
};

// A block's tile on an OH x OW output grid: whole rows (TW = OW), or where
// one row does not fit, a width chunk halved until it does; then the most
// rows, up to MAX_TILE_ROWS and MAX_TILE_PX pixels, whose block fits in
// `budget` bytes of shared memory: 1 KB of alignment slack, the BN x 128
// weight tile, in_rows(th) input rows of in_bytes(tw) bytes (global pitch
// in_gp) and th staged output rows of tw x Cout bytes (global pitch
// out_gp). At 416^2 (v3's entry conv, 3 -> 32: 4 x 416 tiles, two 66.3 KB
// blocks per SM) and 208^2 pooled (slim's conv1, 3 -> 16: 9 x 208 tiles,
// three 65.0 KB blocks).
template <class InRows, class InBytes>
RowPlan plan_rows(int OH, int OW, int Cout, int bn, InRows in_rows,
                  InBytes in_bytes, long long in_gp, long long out_gp,
                  int budget) {
  const auto smem = [&](int th, int tw) {
    return 1024 + bn * 128 +
           round16(in_rows(th) * in_pitch(in_bytes(tw), in_gp)) +
           th * out_pitch(tw * Cout, out_gp) + 16;
  };
  RowPlan p{1, OW, 0, 0, 0};
  while (smem(1, p.tw) > budget && p.tw > 1) p.tw = (p.tw + 1) / 2;
  if (smem(1, p.tw) > budget) return p;
  while (p.th < std::min(OH, MAX_TILE_ROWS) &&
         (p.th + 1) * p.tw <= MAX_TILE_PX && smem(p.th + 1, p.tw) <= budget)
    ++p.th;
  p.rp = in_pitch(in_bytes(p.tw), in_gp);
  p.op = out_pitch(p.tw * Cout, out_gp);
  p.smem = smem(p.th, p.tw);
  return p;
}

// Sets a kernel's shared memory for plan p, then reports its layout in
// `info` or launches it over `tiles` blocks (grid x).
template <class Args>
int launch_rows(void (*kern)(Args), const Args& a, const RowPlan& p, int bn,
                long long tiles, int* info, cudaStream_t st) {
  if (p.smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                        THREADS, p.smem);
    if (err != cudaSuccess) return (int)err;
    const int vals[INFO_LEN] = {p.th, p.tw, p.smem, blocks,
                                bn,   2,    p.rp,   p.op};
    for (int k = 0; k < INFO_LEN; ++k) info[k] = vals[k];
    return 0;
  }
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)tiles, THREADS, p.smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int BN, bool SHORT, Cols C>
int launch_entry(EntryArgsOf<C> a, int* info, cudaStream_t st) {
  const RowPlan p = plan_rows(
      a.H, a.W, a.Cout, BN, [](int th) { return th + 2; },
      [&](int tw) { return (tw + 2) * a.Cin; }, (long long)a.W * a.Cin,
      (long long)a.W * a.Cout, sm_share(EntryCfg<BN>::BLOCKS));
  a.TH = p.th;
  a.TW = p.tw;
  a.RP = p.rp;
  a.OP = p.op;
  return launch_rows(entry_conv3x3_wgmma<BN, SHORT, C>, a, p, BN,
                     (long long)a.B * ((a.H + p.th - 1) / p.th) *
                         ((a.W + p.tw - 1) / p.tw),
                     info, st);
}

template <int BN, bool SHORT, In IN, Cols C>
int launch_pool(PoolArgsOf<C> a, int* info, cudaStream_t st) {
  const int C4 = 4 * a.Cin;
  // the NHWC form's pooled tile reads 2 TH + 2 input rows of 2 TW + 2
  // pixels, K2's TH + 1 s2d rows of TW + 1
  constexpr bool NHWC = IN == In::nhwc;
  const RowPlan p = plan_rows(
      a.Ho, a.Wo, a.Cout, BN,
      [](int th) { return IN == In::nhwc ? 2 * th + 2 : th + 1; },
      [&](int tw) { return NHWC ? (2 * tw + 2) * a.Cin : (tw + 1) * C4; },
      NHWC ? 2LL * a.Wo * a.Cin : (long long)(a.Wo + 3) * C4,
      (long long)a.Wo * a.Cout, sm_share(PoolCfg<BN>::BLOCKS));
  a.TH = p.th;
  a.TW = p.tw;
  a.RP = p.rp;
  a.OP = p.op;
  return launch_rows(pool_wgmma<BN, SHORT, IN, C>, a, p, BN,
                     (long long)a.B * ((a.Ho + p.th - 1) / p.th) *
                         ((a.Wo + p.tw - 1) / p.tw),
                     info, st);
}

bool bad_entry(int H, int W, int Cin, int Cout) {
  return H < 1 || W < 1 || Cin < 1 || Cin > 3 || Cout < 1 || Cout > 64;
}

bool bad_pool(int H, int W, int Cin, int Cout) {
  return H < 2 || W < 2 || H % 2 || W % 2 || Cin < 1 || Cin > 4 ||
         Cout < 1 || Cout > 32;
}

// the 32-column form where Cout <= 32, else the 64-column one
template <Cols C = Cols::scalar>
int entry(const EntryArgsOf<C>& a, bool short_form, int* info,
          cudaStream_t st) {
  if (a.Cout <= 32)
    return short_form ? launch_entry<32, true, C>(a, info, st)
                      : launch_entry<32, false, C>(a, info, st);
  return short_form ? launch_entry<64, true, C>(a, info, st)
                    : launch_entry<64, false, C>(a, info, st);
}

// The entry conv's arguments for an H x W x Cin -> Cout conv
EntryArgs entry_args(const void* x, const void* wp, const void* bias_rt,
                     void* out, int B, int H, int W, int Cin, int Cout) {
  EntryArgs a{};
  a.x = static_cast<const int8_t*>(x);
  a.wp = static_cast<const int8_t*>(wp);
  a.bias = static_cast<const int*>(bias_rt);
  a.out = static_cast<int8_t*>(out);
  a.x_bytes = (long long)B * H * W * Cin;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  return a;
}

// phases of 16 columns where Cout <= 16, else of 32; the short shift form
// where short_form (never when counting)
template <In IN, Cols C = Cols::scalar>
int pool(const PoolArgsOf<C>& a, bool short_form, int* info,
         cudaStream_t st) {
  if constexpr (C != Cols::count)
    if (short_form)
      return a.Cout <= 16 ? launch_pool<64, true, IN, C>(a, info, st)
                          : launch_pool<128, true, IN, C>(a, info, st);
  return a.Cout <= 16 ? launch_pool<64, false, IN, C>(a, info, st)
                      : launch_pool<128, false, IN, C>(a, info, st);
}

// The pooled conv's arguments for an H x W x Cin -> Cout conv whose input
// (of x_bytes bytes) is at x
PoolArgs pool_args(const void* x, long long x_bytes, const void* wp,
                   const void* bias_rt, void* out, int B, int H, int W,
                   int Cin, int Cout) {
  PoolArgs a{};
  a.x = static_cast<const int8_t*>(x);
  a.wp = static_cast<const int8_t*>(wp);
  a.bias = static_cast<const int*>(bias_rt);
  a.out = static_cast<int8_t*>(out);
  a.x_bytes = x_bytes;
  a.B = B;
  a.Ho = H / 2;
  a.Wo = W / 2;
  a.Cin = Cin;
  a.Cout = Cout;
  return a;
}

// The NHWC form with one accumulator shift per output column (C = column)
// or counting (C = count): the table `shifts`; the short shift form where
// every entry and out_shift lie in [0, 31] (short_cols: the entries,
// checked by the caller), never when counting.
template <Cols C>
int run_nhwc_cols(const void* x, const void* wp, const void* bias_rt,
                  const void* shifts, void* out, void* overflow, int B, int H,
                  int W, int Cin, int Cout, int short_cols, int out_shift,
                  int slope_num, int nearest, void* stream) {
  if (bad_pool(H, W, Cin, Cout) || B < 1 || shifts == nullptr ||
      (C == Cols::count) != (overflow != nullptr))
    return (int)cudaErrorInvalidValue;
  ColsArgs a{};
  static_cast<PoolArgs&>(a) = pool_args(x, (long long)B * H * W * Cin, wp,
                                        bias_rt, out, B, H, W, Cin, Cout);
  a.epi = make_epi(0, out_shift, slope_num, nearest != 0);
  a.shifts = static_cast<const int*>(shifts);
  a.overflow = static_cast<int*>(overflow);
  return pool<In::nhwc, C>(a, short_cols && short_shift(out_shift), nullptr,
                           static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// x: int8 NHWC [B, H, W, Cin], 1 <= Cin <= 3; wp: int8 [Cout, 32] in (dy,
// dx, c) order, zero past 9 Cin (pack_entry_conv_weights); bias_rt: int32
// [64] at the retune scale, zero past Cout; out: int8 [B, H, W, Cout],
// Cout <= 64; x, wp and out 16-byte aligned. acc_shift brings the
// accumulator to the retune scale, out_shift the activation to the output
// scale; slope_num: the LeakyReLU slope * 65536. The kernel picks its tile
// (plan_rows; reported by yolo_int8_entry_conv3x3_wgmma_info). Returns the
// first CUDA error of setting up or launching.
int yolo_int8_entry_conv3x3_wgmma(const void* x, const void* wp,
                                  const void* bias_rt, void* out, int B,
                                  int H, int W, int Cin, int Cout,
                                  int acc_shift, int out_shift, int slope_num,
                                  int nearest, void* stream) {
  if (bad_entry(H, W, Cin, Cout) || B < 1) return (int)cudaErrorInvalidValue;
  EntryArgs a = entry_args(x, wp, bias_rt, out, B, H, W, Cin, Cout);
  a.epi = make_epi(acc_shift, out_shift, slope_num, nearest != 0);
  return entry(a, short_shift(acc_shift) && short_shift(out_shift), nullptr,
               static_cast<cudaStream_t>(stream));
}

// The entry conv with one accumulator shift per output column (a
// per-channel sw): shifts: int32 [>= 64], each column's shift as _shift
// reads it (int8_conv.py's acc_shift_table), 0 past Cout, 8-byte aligned;
// short_cols: every entry in [0, 31]. Otherwise as
// yolo_int8_entry_conv3x3_wgmma, whose layout it has.
int yolo_int8_entry_conv3x3_cols_wgmma(const void* x, const void* wp,
                                       const void* bias_rt,
                                       const void* shifts, void* out, int B,
                                       int H, int W, int Cin, int Cout,
                                       int short_cols, int out_shift,
                                       int slope_num, int nearest,
                                       void* stream) {
  if (bad_entry(H, W, Cin, Cout) || B < 1 || shifts == nullptr)
    return (int)cudaErrorInvalidValue;
  EntryColsArgs a{};
  static_cast<EntryArgs&>(a) =
      entry_args(x, wp, bias_rt, out, B, H, W, Cin, Cout);
  a.epi = make_epi(0, out_shift, slope_num, nearest != 0);
  a.shifts = static_cast<const int*>(shifts);
  return entry<Cols::column>(a, short_cols && short_shift(out_shift),
                             nullptr, static_cast<cudaStream_t>(stream));
}

// The entry conv's layout for an H x W x Cin -> Cout conv: info[0..7] =
// tile height, tile width, dynamic shared memory bytes, resident blocks
// per SM, columns (BN), warpgroups, shared input and output row pitches.
// Returns 0, or an error code where the shape is not taken or no tile fits.
int yolo_int8_entry_conv3x3_wgmma_info(int H, int W, int Cin, int Cout,
                                       int* info_out) {
  if (bad_entry(H, W, Cin, Cout)) return (int)cudaErrorInvalidValue;
  EntryArgs a{};
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  return entry(a, true, info_out, nullptr);
}

// x2: int8 [B, H/2 + 3, W/2 + 3, 4 Cin], the padded space-to-depth layout
// of an H x W image (H, W even), 1 <= Cin <= 4; wp: int8 [4 CP, 64]
// (pack_pool_s2d_weights: row p CP + co of pool phase p, CP = 16 where
// Cout <= 16, else 32; K in the s2d window's (r, s, py, px, c) order, zero
// past 16 Cin); bias_rt: int32 [32], zero past Cout; out: int8 [B, H/2,
// W/2, Cout], Cout <= 32; x2, wp and out 16-byte aligned. Shifts and slope
// as yolo_int8_entry_conv3x3_wgmma; layout: yolo_int8_pool_s2d_wgmma_info.
int yolo_int8_pool_s2d_wgmma(const void* x2, const void* wp,
                             const void* bias_rt, void* out, int B, int H,
                             int W, int Cin, int Cout, int acc_shift,
                             int out_shift, int slope_num, int nearest,
                             void* stream) {
  if (bad_pool(H, W, Cin, Cout) || B < 1) return (int)cudaErrorInvalidValue;
  PoolArgs a =
      pool_args(x2, (long long)B * (H / 2 + 3) * (W / 2 + 3) * 4 * Cin, wp,
                bias_rt, out, B, H, W, Cin, Cout);
  a.epi = make_epi(acc_shift, out_shift, slope_num, nearest != 0);
  return pool<In::s2d>(a, short_shift(acc_shift) && short_shift(out_shift),
                       nullptr, static_cast<cudaStream_t>(stream));
}

// K2's layout for an H x W x Cin -> Cout pooled conv (its tile in pooled
// pixels), info[0..7] as yolo_int8_entry_conv3x3_wgmma_info's.
int yolo_int8_pool_s2d_wgmma_info(int H, int W, int Cin, int Cout,
                                  int* info_out) {
  if (bad_pool(H, W, Cin, Cout)) return (int)cudaErrorInvalidValue;
  return pool<In::s2d>(
      pool_args(nullptr, 0, nullptr, nullptr, nullptr, 0, H, W, Cin, Cout),
      true, info_out, nullptr);
}

// The NHWC form: x int8 NHWC [B, H, W, Cin] (H, W even), 1 <= Cin <= 4;
// wp: int8 [4 CP, 64] (pack_pool_nhwc_weights: row p CP + co of pool phase
// p, CP as K2's; K in the 4x4 window's (dy, dx, c) order, zero past 16
// Cin); bias_rt: int32 [32], zero past Cout; out: int8 [B, H/2, W/2,
// Cout], Cout <= 32; x, wp and out 16-byte aligned. Shifts and slope as
// yolo_int8_entry_conv3x3_wgmma; layout: yolo_int8_pool_nhwc_wgmma_info.
int yolo_int8_pool_nhwc_wgmma(const void* x, const void* wp,
                              const void* bias_rt, void* out, int B, int H,
                              int W, int Cin, int Cout, int acc_shift,
                              int out_shift, int slope_num, int nearest,
                              void* stream) {
  if (bad_pool(H, W, Cin, Cout) || B < 1) return (int)cudaErrorInvalidValue;
  PoolArgs a = pool_args(x, (long long)B * H * W * Cin, wp, bias_rt, out, B,
                         H, W, Cin, Cout);
  a.epi = make_epi(acc_shift, out_shift, slope_num, nearest != 0);
  return pool<In::nhwc>(a, short_shift(acc_shift) && short_shift(out_shift),
                        nullptr, static_cast<cudaStream_t>(stream));
}

// The NHWC form with one accumulator shift per output column (a
// per-channel sw): shifts: int32 [>= 32], each column's shift as _shift
// reads it (int8_conv.py's acc_shift_table), 0 past Cout, 8-byte aligned;
// short_cols: every entry in [0, 31].
int yolo_int8_pool_nhwc_cols_wgmma(const void* x, const void* wp,
                                   const void* bias_rt, const void* shifts,
                                   void* out, int B, int H, int W, int Cin,
                                   int Cout, int short_cols, int out_shift,
                                   int slope_num, int nearest, void* stream) {
  return run_nhwc_cols<Cols::column>(x, wp, bias_rt, shifts, out, nullptr,
                                     B, H, W, Cin, Cout, short_cols,
                                     out_shift, slope_num, nearest, stream);
}

// The NHWC form with per-column shifts that also adds to *overflow (int32)
// how many conv outputs, all four values of each 2x2 window before the
// pool, lie outside int16 after the accumulator shift and the bias.
int yolo_int8_pool_nhwc_count_wgmma(const void* x, const void* wp,
                                    const void* bias_rt, const void* shifts,
                                    void* out, void* overflow, int B, int H,
                                    int W, int Cin, int Cout, int out_shift,
                                    int slope_num, int nearest,
                                    void* stream) {
  return run_nhwc_cols<Cols::count>(x, wp, bias_rt, shifts, out, overflow,
                                    B, H, W, Cin, Cout, 0, out_shift,
                                    slope_num, nearest, stream);
}

// The NHWC form's layout (every shift form's), info[0..7] as K2's.
int yolo_int8_pool_nhwc_wgmma_info(int H, int W, int Cin, int Cout,
                                   int* info_out) {
  if (bad_pool(H, W, Cin, Cout)) return (int)cudaErrorInvalidValue;
  return pool<In::nhwc>(
      pool_args(nullptr, 0, nullptr, nullptr, nullptr, 0, H, W, Cin, Cout),
      true, info_out, nullptr);
}

}  // extern "C"
