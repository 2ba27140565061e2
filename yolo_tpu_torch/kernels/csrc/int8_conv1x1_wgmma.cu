// Int8 1x1 conv (stride 1, pad 0) + fixed-point requant, for Hopper
// (sm_90a), as a GEMM on wgmma fed by a TMA ring: int8 NHWC input at scale
// 2^sa_in, one part [M = B * H * W, Cin] or the channel concat of two
// parts at their own scales, each Cin % 16 == 0 -> int8 [M, Cout], any
// Cout >= 1. Plain C interface, loaded with ctypes by
// yolo_tpu_torch/kernels/int8_conv.py, whose int8_conv_requant sends every
// conv of that shape here (conv1x1_wgmma_route); the weights are packed
// K-major once per model (pack_conv1x1_weights) as [Cout, Cin0 + Cin1].
//
// Replaces no Pallas kernel: it is the card's counterpart of XLA's integer
// conv in yolo_tpu/quant/fixed_point.py::int_conv_requant (the
// conv_general_dilated at :725) at yolo_v3's fourteen 1x1 convs: nine 1x1s
// of the head, the two concat 1x1s after each upsample (each part's
// partial shifted to the retune scale on its own before the two are
// summed where the parts' shifts differ, :731-736) and the three preds
// (Cout 21, no activation). The leaky slope is 0.125, none, or any Q16
// rational; both roundings; shifts >= 32 and < 0 as fixed_point._shift.
//
// What bounds it on an H100: 2 * Cin * Cout ops per pixel against Cin
// bytes in and Cout out, so a conv is bound by bytes below Cout ~ 590 ops
// per byte (1,979 dense int8 TOPS over 3.35 TB/s). At batch 128, 416^2,
// the fourteen do ~245 GOP (0.124 ms) and move ~979 MB (0.29 ms): only
// 13^2 1024 -> 512 (683 ops per byte) sits above the ridge; the other
// thirteen stream their activation. Beside the bytes, the requant chain
// costs ~16 integer instructions per output value (~258 M values per
// forward: ~0.3 ms of the SMs' integer issue), so the design keeps the
// stream of A, the wgmmas and the epilogue running at once:
//   - the weights of the block's BN output columns, all of K, are loaded
//     once into shared memory by TMA (one mbarrier per 128-deep K step, so
//     the first tile starts on the first step) and stay resident, so only
//     the activation streams: each A row is read from HBM once per BN
//     columns, and blocks with neighbouring indices take the other column
//     tiles of the same rows at the same time, so the other reads hit L2.
//     BN is the narrowest of 32 / 64 / 128 / 256 that covers Cout (256
//     past that), halved while the resident weights and two 2-stage rings
//     do not fit: 128 at 13^2 1024 -> 512 (four column tiles), 256 at 512 ->
//     256, 128 at 256 -> 128, 32 at the preds (TMA zero-fills weight rows
//     21-31), and at most 128 where a concat's two parts take two shifts
//     (their partials need a second accumulator);
//   - one block per SM walks over M tiles of 64 rows (a persistent loop);
//     two consumer warpgroups take alternate tiles (ping-pong), so one
//     runs its wgmmas (m64nBNk32, A and B from shared memory) while the
//     other requantizes. Each has a ring of 8 KB A stages of its own, kept
//     full by a producer thread of its own (2-D TMA boxes of 64 rows x 128
//     bytes, 128-byte swizzle, K and M edges zero-filled), 4 stages deep
//     (on an H100 the fourteen ran 3% faster than with rings of 8, which
//     let each SM keep twice the bytes in flight; 2 stages ran slower:
//     PERF.md, section 6). One ring read by
//     both in turn would let a warpgroup wait on round r of a stage whose
//     round r - 1, the other's, has not landed yet (TMA loads complete out
//     of order): the parity wait would pass at once. A two-part input runs
//     part 0's K steps and then part 1's into the same accumulator where
//     both shifts agree, else shifts part 0's partial into a second
//     register array first;
//   - the epilogue of int8_wgmma_conv.cuh: one branch-free shift form set
//     up on the host (the SHORT form where every shift is in [0, 31]),
//     pairs clamped and packed by cvt.pack.sat into a 64 x 64 staging tile
//     per warpgroup, then 16-byte stores (byte stores where Cout % 16 != 0
//     leaves the output rows unaligned, as the preds' 21-byte rows).
// With a per-channel sw (quantize_pipeline_yolo_v3(per_channel=True) of
// the JAX package) the per-column form (Cols::column) takes each column's
// accumulator shift from a table (int8_conv.py's acc_shift_table: sw[c] +
// sa - retune, _shift_arr mapped onto _shift's codes), an int2 per column
// pair read through the read-only cache, its Shift made in registers
// (column_shift of int8_wgmma_conv.cuh). A concat's parts of equal input
// scale take one table and run as one accumulator; parts of different
// scales (int_conv_requant's groups) a table each: part 0's partial is
// shifted by its own table's columns into the second accumulator. The
// scalar instantiations are those of before: the tables sit in a
// derived argument struct that only the per-column form takes.

#include <climits>
#include <type_traits>

#include "int8_wgmma_conv.cuh"

namespace {

constexpr int BM = 64;             // rows of a tile: one warpgroup's
constexpr int A_STAGE = BM * SW;   // 8 KB: one 128-deep K step of a tile
constexpr int MAX_RING = 4;        // stages of each warpgroup's ring
constexpr int MAX_KSTEPS = 32;     // K steps of the resident weights
constexpr int THREADS = 384;       // 2 consumer + 1 producer warpgroup
constexpr int INFO_LEN = 8;

struct Conv1Args {
  const int* bias;  // [Cout rounded up to 256], retune scale, 0 past Cout
  int8_t* out;      // [M, Cout]
  int M, Cout;
  int nk0, nk;      // 128-deep K steps of part 0, of both parts
  int c0;           // part 0's channels: part 1's first weight column
  int ntm, ntn, mb; // M tiles, column tiles, blocks along M
  int stages;       // depth of each warpgroup's ring
  int split;        // two parts of different shifts
  Shift sh0;        // part 0's accumulator shift, where split
  Epi epi;          // its acc shift: the last part's
};

// the accumulator shifts: one for the conv (Conv1Args' sh0 and epi.acc),
// or per output column from a shift table (a per-channel sw)
enum class Cols { scalar, column };

// the per-column form's arguments: the accumulator shift table of the last
// part (of every part where their shifts agree) and, where split, part
// 0's, each [Cout rounded up to 256], 0 past Cout
struct Conv1ColsArgs : Conv1Args {
  const int* shifts0;
  const int* shifts1;
};

template <Cols C>
using Conv1ArgsOf =
    std::conditional_t<C == Cols::scalar, Conv1Args, Conv1ColsArgs>;

template <int N>
__device__ __forceinline__ void mma_ss(int (&d)[N / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (N == 32) mma_ss_n32(d, da, db, 1);
  if constexpr (N == 64) mma_ss_n64(d, da, db, 1);
  if constexpr (N == 128) mma_ss_n128(d, da, db, 1);
  if constexpr (N == 256) mma_ss_n256(d, da, db, 1);
}

// Requantize a warpgroup's 64 x BN accumulator and store it at rows m0..,
// columns n0..: PW columns at a time through the 64 x 64 staging tile.
// With SPLIT the accumulator holds part 1's partial and `stash` part 0's,
// already at the retune scale. Cols::column: each column's accumulator
// shift from `shifts` (epi.acc unused).
template <int BN, bool SHORT, bool SPLIT, Cols C = Cols::scalar>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2],
                                           const int (&stash)[BN / 2],
                                           const Epi epi, const int* bias,
                                           int8_t* out, const int M,
                                           const int Cout, int8_t* stg,
                                           const int m0, const int n0,
                                           const int* shifts = nullptr) {
  constexpr int PW = BN < 64 ? BN : 64;  // columns per pass
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int ltid = tid & 127;
#pragma unroll
  for (int pass = 0; pass < BN / PW; ++pass) {
    const int col0 = n0 + pass * PW;
#pragma unroll
    for (int j = 0; j < PW / 8; ++j) {
      const int cl = 8 * j + 2 * tig;
      const int2 bb = *reinterpret_cast<const int2*>(bias + col0 + cl);
      if constexpr (C == Cols::column) {
        const bool nearest = epi.rnd != 0;
        const int2 sc =
            __ldg(reinterpret_cast<const int2*>(shifts + col0 + cl));
        const Shift s0 = column_shift<SHORT>(sc.x, nearest);
        const Shift s1 = column_shift<SHORT>(sc.y, nearest);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * (pass * (PW / 8) + j) + 2 * h;
          int u0 = s0.apply<SHORT>(acc[e]), u1 = s1.apply<SHORT>(acc[e + 1]);
          if constexpr (SPLIT) {
            u0 = (int)((unsigned)u0 + (unsigned)stash[e]);
            u1 = (int)((unsigned)u1 + (unsigned)stash[e + 1]);
          }
          *reinterpret_cast<uint16_t*>(
              stg + stg_at(warp * 16 + gid + 8 * h, cl)) =
              pack_sat2(epi.rest<SHORT>(u0, bb.x), epi.rest<SHORT>(u1, bb.y));
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * (pass * (PW / 8) + j) + 2 * h;
          int v0, v1;
          if constexpr (SPLIT) {
            v0 = epi.rest<SHORT>(
                (int)((unsigned)epi.acc.apply<SHORT>(acc[e]) +
                      (unsigned)stash[e]),
                bb.x);
            v1 = epi.rest<SHORT>(
                (int)((unsigned)epi.acc.apply<SHORT>(acc[e + 1]) +
                      (unsigned)stash[e + 1]),
                bb.y);
          } else {
            v0 = epi.unclamped<SHORT>(acc[e], bb.x);
            v1 = epi.unclamped<SHORT>(acc[e + 1], bb.y);
          }
          *reinterpret_cast<uint16_t*>(
              stg + stg_at(warp * 16 + gid + 8 * h, cl)) = pack_sat2(v0, v1);
        }
      }
    }
    named_sync(2 + wg, 128);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int rl = (ltid + 128 * q) >> 2, c16 = ltid & 3;
      const int left = min(Cout - col0, PW) - 16 * c16;  // columns to store
      if (m0 + rl >= M || left <= 0) continue;
      const uint4 o =
          *reinterpret_cast<const uint4*>(stg + stg_at(rl, 16 * c16));
      int8_t* dst = out + (long long)(m0 + rl) * Cout + col0 + 16 * c16;
      if (Cout % 16 == 0) {
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

template <int BN, bool SHORT, Cols C>
__global__ void __launch_bounds__(THREADS, 1)
conv1x1_wgmma(const __grid_constant__ CUtensorMap tm_a0,
              const __grid_constant__ CUtensorMap tm_a1,
              const __grid_constant__ CUtensorMap tm_w, Conv1ArgsOf<C> a) {
  // a second accumulator for part 0's shifted partial (two-part inputs of
  // two shifts, which the host runs at BN <= 128 only; on an H100 the
  // per-column form's splits ran 24-31% slower at 64 columns, PERF.md,
  // section 6)
  constexpr bool CAN_SPLIT = BN <= 128;
  extern __shared__ __align__(16) unsigned char dsmem[];
  // the swizzled tiles need 1024-byte alignment: an offset from the shared
  // array itself, so that every access stays a shared one
  unsigned char* smem = dsmem + ((1024u - (smem_u32(dsmem) & 1023u)) & 1023u);
  unsigned char* wres = smem;  // nk steps of BN rows x 128 bytes
  int8_t* stg_all = reinterpret_cast<int8_t*>(wres + a.nk * BN * SW +
                                              2 * a.stages * A_STAGE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stg_all + 2 * STG_BYTES);
  uint64_t* wfull = bars + 4 * MAX_RING;  // one per weight K step
  const int tid = threadIdx.x, wg = tid >> 7;
  // the ring of consumer warpgroup w, w = 0, 1 (its producer: thread
  // 256 + 32 w), and its stages
  const auto ring_of = [=](int w) {
    return Ring{bars + 2 * MAX_RING * w, bars + 2 * MAX_RING * w + MAX_RING,
                a.stages};
  };
  const auto stage_of = [=](int w, int i) {
    return wres + a.nk * BN * SW + (w * a.stages + i % a.stages) * A_STAGE;
  };
  // column tiles fastest, so the blocks that read the same rows run
  // together; this block's M tiles: mblk, mblk + mb, ...
  const int n0 = (int)(blockIdx.x % a.ntn) * BN;
  const int mblk = (int)(blockIdx.x / a.ntn);
  const int nt = (a.ntm - mblk + a.mb - 1) / a.mb;

  if (tid == 0) {
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < a.stages; ++s) {
        mbar_init(&ring_of(w).full[s], 1);
        mbar_init(&ring_of(w).empty[s], 4);  // the warps of its reader
      }
    for (int s = 0; s < a.nk; ++s) mbar_init(&wfull[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producers: thread 256 loads the weights once; threads 256 and
    // 288 each keep one consumer warpgroup's ring full, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      tma_prefetch_map(&tm_a0);
      tma_prefetch_map(&tm_a1);
      tma_prefetch_map(&tm_w);
      for (int s = 0; s < a.nk; ++s) {
        mbar_expect_tx(&wfull[s], BN * SW);
        tma_load_2d(wres + s * BN * SW, &tm_w, &wfull[s],
                    s < a.nk0 ? s * SW : a.c0 + (s - a.nk0) * SW, n0);
      }
    }
    if (tid == 256 || tid == 288) {
      const int w = (tid - 256) >> 5;
      const Ring ring = ring_of(w);
      for (int j = w, i = 0; j < nt; j += 2) {
        const int m0 = (mblk + j * a.mb) * BM;
        for (int k = 0; k < a.nk; ++k, ++i) {
          ring.producer_acquire(i, A_STAGE);
          const bool p1 = k >= a.nk0;
          tma_load_2d(stage_of(w, i), p1 ? &tm_a1 : &tm_a0,
                      &ring.full[ring.stage(i)], (p1 ? k - a.nk0 : k) * SW,
                      m0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes the block's tiles j = wg, wg + 2, ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  int8_t* stg = stg_all + wg * STG_BYTES;
  const Ring ring = ring_of(wg);
  for (int j = wg, i = 0; j < nt; j += 2) {
    const int m0 = (mblk + j * a.mb) * BM;
    int acc[BN / 2];
    int stash[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
    int prev = -1;
    for (int k = 0; k < a.nk; ++k, ++i) {
      if constexpr (CAN_SPLIT) {
        if (a.split && k == a.nk0) {
          // part 0 done: its partial to the retune scale, part 1 afresh
          wgmma_wait<0>();
          ring.consumer_release(prev);
          prev = -1;
          if constexpr (C == Cols::scalar) {
#pragma unroll
            for (int e = 0; e < BN / 2; ++e) {
              stash[e] = a.sh0.apply<SHORT>(acc[e]);
              acc[e] = 0;
            }
          } else {
            // columns 8 jj + 2 tig (+1) of the tile: accumulators 4 jj +
            // 2 h (+1), rows gid + 8 h
            const bool nearest = a.epi.rnd != 0;
            const int tig = tid & 3;
#pragma unroll
            for (int jj = 0; jj < BN / 8; ++jj) {
              const int2 sc = __ldg(reinterpret_cast<const int2*>(
                  a.shifts0 + n0 + 8 * jj + 2 * tig));
              const Shift s0 = column_shift<SHORT>(sc.x, nearest);
              const Shift s1 = column_shift<SHORT>(sc.y, nearest);
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
      if (j < 2) mbar_wait(&wfull[k], 0);  // the weights, once
      ring.consumer_wait(i);
      const uint64_t da = desc_sw128(stage_of(wg, i));
      const uint64_t db = desc_sw128(wres + k * BN * SW);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SW / 32; ++kk) mma_ss<BN>(acc, da + 2 * kk,
                                                     db + 2 * kk);
      wgmma_commit();
      // keep this step's wgmmas in flight; the previous step's are retired
      wgmma_wait<1>();
      if (prev >= 0) ring.consumer_release(prev);
      prev = i;
    }
    wgmma_wait<0>();
    ring.consumer_release(prev);
    if constexpr (C == Cols::scalar) {
      if (CAN_SPLIT && a.split)
        store_tile<BN, SHORT, CAN_SPLIT>(acc, stash, a.epi, a.bias, a.out,
                                         a.M, a.Cout, stg, m0, n0);
      else
        store_tile<BN, SHORT, false>(acc, stash, a.epi, a.bias, a.out, a.M,
                                     a.Cout, stg, m0, n0);
    } else {
      if (CAN_SPLIT && a.split)
        store_tile<BN, SHORT, CAN_SPLIT, C>(acc, stash, a.epi, a.bias, a.out,
                                            a.M, a.Cout, stg, m0, n0,
                                            a.shifts1);
      else
        store_tile<BN, SHORT, false, C>(acc, stash, a.epi, a.bias, a.out,
                                        a.M, a.Cout, stg, m0, n0, a.shifts1);
    }
  }
}

// dynamic shared memory of a block: alignment slack, the resident weights
// (nk steps of bn rows), the two rings, two staging tiles and the
// mbarriers
int conv1_smem(int nk, int bn, int stages) {
  return 1024 + nk * bn * SW + 2 * stages * A_STAGE + 2 * STG_BYTES +
         (4 * MAX_RING + MAX_KSTEPS) * 8;
}

struct Plan {
  int bn, stages, smem;  // smem 0: nothing fits
};

// The narrowest column tile that covers Cout (256 past it), at most 128
// where a split needs the second accumulator, halved while the resident
// weights and two 2-stage rings do not fit; then rings of up to MAX_RING
// stages. Both shift forms take the same plan.
Plan plan(int Cout, int nk, bool split) {
  Plan p{Cout <= 32 ? 32 : Cout <= 64 ? 64 : Cout <= 128 ? 128 : 256, 2, 0};
  if (split) p.bn = std::min(p.bn, 128);
  while (p.bn > 32 && conv1_smem(nk, p.bn, 2) > MAX_SMEM) p.bn /= 2;
  if (conv1_smem(nk, p.bn, 2) > MAX_SMEM) return p;
  while (p.stages < MAX_RING && conv1_smem(nk, p.bn, p.stages + 1) <= MAX_SMEM)
    ++p.stages;
  p.smem = conv1_smem(nk, p.bn, p.stages);
  return p;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// Launches the kernel of `bn` columns, or with `info` reports its layout
// there instead.
template <int BN, bool SHORT, Cols C>
int launch_bn(Conv1ArgsOf<C> a, const Plan& p, const void* x0,
              const void* x1, const void* wp, int cin0, int cin1, int* info,
              cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      conv1x1_wgmma<BN, SHORT, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  const int rc_sm = sm_count(&sms);
  if (rc_sm != 0) return rc_sm;
  a.stages = p.stages;
  a.ntm = (a.M + BM - 1) / BM;
  a.ntn = (a.Cout + BN - 1) / BN;
  a.mb = std::max(1, std::min(a.ntm, sms / a.ntn));
  const long long grid = (long long)a.ntn * a.mb;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  if (info != nullptr) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, conv1x1_wgmma<BN, SHORT, C>, THREADS, p.smem);
    if (err != cudaSuccess) return (int)err;
    const int vals[INFO_LEN] = {BM,       BN,     p.stages,   blocks,
                                p.smem,   (int)grid, a.ntn, a.nk * BN * SW};
    for (int k = 0; k < INFO_LEN; ++k) info[k] = vals[k];
    return 0;
  }
  CUtensorMap tm_a0, tm_a1, tm_w;
  const cuuint32_t box_a[2] = {SW, BM}, box_w[2] = {SW, (cuuint32_t)BN};
  const cuuint64_t dims_a0[2] = {(cuuint64_t)cin0, (cuuint64_t)a.M};
  const cuuint64_t str_a0[1] = {(cuuint64_t)cin0};
  int rc = make_map(&tm_a0, x0, 2, dims_a0, str_a0, box_a);
  tm_a1 = tm_a0;
  if (rc == 0 && cin1 > 0) {
    const cuuint64_t dims_a1[2] = {(cuuint64_t)cin1, (cuuint64_t)a.M};
    const cuuint64_t str_a1[1] = {(cuuint64_t)cin1};
    rc = make_map(&tm_a1, x1, 2, dims_a1, str_a1, box_a);
  }
  const cuuint64_t K = (cuuint64_t)(cin0 + cin1);
  const cuuint64_t dims_w[2] = {K, (cuuint64_t)a.Cout}, str_w[1] = {K};
  if (rc == 0) rc = make_map(&tm_w, wp, 2, dims_w, str_w, box_w);
  if (rc != 0) return rc;
  conv1x1_wgmma<BN, SHORT, C>
      <<<(unsigned)grid, THREADS, p.smem, st>>>(tm_a0, tm_a1, tm_w, a);
  return (int)cudaGetLastError();
}

template <bool SHORT, Cols C = Cols::scalar>
int dispatch(const Conv1ArgsOf<C>& a, const Plan& p, const void* x0,
             const void* x1, const void* wp, int cin0, int cin1, int* info,
             cudaStream_t st) {
  switch (p.bn) {
    case 32:
      return launch_bn<32, SHORT, C>(a, p, x0, x1, wp, cin0, cin1, info, st);
    case 64:
      return launch_bn<64, SHORT, C>(a, p, x0, x1, wp, cin0, cin1, info, st);
    case 128:
      return launch_bn<128, SHORT, C>(a, p, x0, x1, wp, cin0, cin1, info,
                                      st);
    default:
      return launch_bn<256, SHORT, C>(a, p, x0, x1, wp, cin0, cin1, info,
                                      st);
  }
}

bool bad_shape(int M, int cin0, int cin1, int Cout) {
  const int nk = (cin0 + SW - 1) / SW + (cin1 + SW - 1) / SW;
  return M < 1 || Cout < 1 || cin0 < 16 || cin0 % 16 || cin1 < 0 ||
         cin1 % 16 || nk > MAX_KSTEPS;
}

// The launch (or, with `info`, the layout) of a conv of these shifts.
int run(const void* x0, const void* x1, const void* wp, const void* bias_rt,
        void* out, int M, int cin0, int cin1, int Cout, int acc_shift0,
        int acc_shift1, int out_shift, int slope_num, int nearest, int* info,
        void* stream) {
  if (bad_shape(M, cin0, cin1, Cout)) return (int)cudaErrorInvalidValue;
  const bool two = cin1 > 0;
  if (!two) acc_shift1 = acc_shift0;
  Conv1Args a{};
  a.bias = static_cast<const int*>(bias_rt);
  a.out = static_cast<int8_t*>(out);
  a.M = M;
  a.Cout = Cout;
  a.nk0 = (cin0 + SW - 1) / SW;
  a.nk = a.nk0 + (cin1 + SW - 1) / SW;
  a.c0 = cin0;
  a.split = acc_shift0 != acc_shift1;
  a.sh0 = make_shift(acc_shift0, nearest != 0);
  a.epi = make_epi(acc_shift1, out_shift, slope_num, nearest != 0);
  const Plan p = plan(Cout, a.nk, a.split);
  if (p.smem == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (short_shift(acc_shift0) && short_shift(acc_shift1) &&
      short_shift(out_shift))
    return dispatch<true>(a, p, x0, x1, wp, cin0, cin1, info, st);
  return dispatch<false>(a, p, x0, x1, wp, cin0, cin1, info, st);
}

// The per-column form's launch: the parts' tables, split where the parts
// take two (shifts0 part 0's, shifts1 part 1's; else shifts1 every
// part's); the short shift form where every entry of the tables and
// out_shift lie in [0, 31] (short_cols: the entries, checked by the
// caller).
int run_cols(const void* x0, const void* x1, const void* wp,
             const void* bias_rt, const void* shifts0, const void* shifts1,
             void* out, int M, int cin0, int cin1, int Cout, int split,
             int short_cols, int out_shift, int slope_num, int nearest,
             void* stream) {
  if (bad_shape(M, cin0, cin1, Cout) || (split && cin1 == 0) ||
      shifts1 == nullptr || (split && shifts0 == nullptr))
    return (int)cudaErrorInvalidValue;
  Conv1ColsArgs a{};
  a.bias = static_cast<const int*>(bias_rt);
  a.out = static_cast<int8_t*>(out);
  a.M = M;
  a.Cout = Cout;
  a.nk0 = (cin0 + SW - 1) / SW;
  a.nk = a.nk0 + (cin1 + SW - 1) / SW;
  a.c0 = cin0;
  a.split = split != 0;
  a.epi = make_epi(0, out_shift, slope_num, nearest != 0);
  a.shifts0 = static_cast<const int*>(shifts0);
  a.shifts1 = static_cast<const int*>(shifts1);
  const Plan p = plan(Cout, a.nk, a.split);
  if (p.smem == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (short_cols && short_shift(out_shift))
    return dispatch<true, Cols::column>(a, p, x0, x1, wp, cin0, cin1,
                                        nullptr, st);
  return dispatch<false, Cols::column>(a, p, x0, x1, wp, cin0, cin1,
                                       nullptr, st);
}

}  // namespace

extern "C" {

// x0: int8 [M, cin0] (an NHWC input, M = B * H * W), and with cin1 > 0 x1:
// int8 [M, cin1], the second part of a channel concat (else x1 is unused
// and cin1 0); each cin % 16 == 0, the two padded to 128 at most 4096
// channels in all. wp: int8 [Cout, cin0 + cin1] (the 1x1 weights K-major);
// bias_rt: int32 [Cout rounded up to 256] at the retune scale, zero past
// Cout; out: int8 [M, Cout]; x0, x1, wp and out 16-byte aligned.
// acc_shift0 / acc_shift1 bring each part's accumulator to the retune
// scale, out_shift the activation to the output scale; slope_num: the
// LeakyReLU slope * 65536 (8192: 0.125; 65536: none). Returns the first
// CUDA error of setting up or launching.
int yolo_int8_conv1x1_wgmma(const void* x0, const void* x1, const void* wp,
                            const void* bias_rt, void* out, int M, int cin0,
                            int cin1, int Cout, int acc_shift0,
                            int acc_shift1, int out_shift, int slope_num,
                            int nearest, void* stream) {
  return run(x0, x1, wp, bias_rt, out, M, cin0, cin1, Cout, acc_shift0,
             acc_shift1, out_shift, slope_num, nearest, nullptr, stream);
}

// The kernel's layout for an M x (cin0 + cin1) -> Cout conv whose parts
// take two different shifts (split != 0) or one: info[0..7] = rows of a
// tile, columns of a tile (BN), stages of each consumer warpgroup's ring,
// resident blocks per SM,
// dynamic shared memory bytes, blocks launched, column tiles, bytes of the
// resident weights. Returns 0, or an error code where the shape is not
// taken.
int yolo_int8_conv1x1_wgmma_info(int M, int cin0, int cin1, int Cout,
                                 int split, int* info_out) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, M, cin0, cin1, Cout,
             0, split ? 1 : 0, 0, 65536, 1, info_out, nullptr);
}

// The per-column form (a per-channel sw): as yolo_int8_conv1x1_wgmma, with
// each column's accumulator shift from a table (int32 [Cout rounded up to
// 256], each column's shift as _shift reads it, int8_conv.py's
// acc_shift_table, 0 past Cout, 8-byte aligned) in place of acc_shift0 /
// acc_shift1: with split != 0 (two parts of different input scales)
// shifts0 is part 0's table and shifts1 part 1's, else shifts1 is every
// part's (shifts0 unused); short_cols: every entry in [0, 31]. Its layout
// is the scalar form's (yolo_int8_conv1x1_wgmma_info).
int yolo_int8_conv1x1_cols_wgmma(const void* x0, const void* x1,
                                 const void* wp, const void* bias_rt,
                                 const void* shifts0, const void* shifts1,
                                 void* out, int M, int cin0, int cin1,
                                 int Cout, int split, int short_cols,
                                 int out_shift, int slope_num, int nearest,
                                 void* stream) {
  return run_cols(x0, x1, wp, bias_rt, shifts0, shifts1, out, M, cin0, cin1,
                  Cout, split, short_cols, out_shift, slope_num, nearest,
                  stream);
}

}  // extern "C"
