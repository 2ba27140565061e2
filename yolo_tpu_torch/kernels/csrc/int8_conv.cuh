// The implicit-GEMM int8 conv kernel of the port, for Hopper (sm_90a):
// k x k taps (k = 1 or 3) at any stride and zero padding, over one NHWC
// input or the channel concat of two differently scaled inputs, with an
// optional 2x2/2 max pool, and the fixed-point requant epilogue.
// Instantiated by int8_conv.cu (K1-K3: k = 3, stride 1, pad 1, one input)
// and int8_conv_general.cu (int8_conv_requant), two sources so that nvcc
// builds them in parallel.
//
// GEMM view: rows = output pixels (with POOL the four conv pixels of each
// pooled pixel are four consecutive rows), columns = C_out, depth =
// k*k*C_in in (dy, dx, ci) order = the HWIO weights. A two-part input runs
// the K loop over part 1, shifts that partial to the retune scale, then
// runs part 2 into a fresh accumulator (parts of equal shift share one
// accumulator, as fixed_point.int_conv_requant groups them).
//
// What bounds it on an H100: the convs of slim_yolo_v2 (~2.52 GMAC per
// 416^2 image) and yolo_v3 (~32.7 GMAC) are bound by operations: at the
// data sheet's 1,979 dense int8 TOPS and 3.35 TB/s every layer with
// C_in >= 64 needs more time for its products than for its int8 bytes.
// So the products run on the tensor cores (mma.sync m16n8k32 s8 -> s32).
// Each block computes a 128-row x BN-column tile (BN = 16/32/64, matched
// to the columns so narrow layers waste none); the A tile is gathered
// straight from the activation (16-byte loads when C_in % 16 == 0, else
// byte by byte), the B tile is read from the HWIO weights and transposed
// 4x4 bytes in registers, and the next K tile's global loads are in
// flight while the current one is multiplied (two shared-memory stages,
// one barrier per K tile; int8_common.cuh). The int32 accumulator, the
// pool max and the requant chain stay in registers; the int8 tile is
// staged in shared memory and written with 16-byte stores. Only int8
// crosses device memory, and pooled layers never write their pre-pool
// activation. wgmma with TMA-fed multi-stage tiles is the next step toward
// the tensor-core bound.
//
// The requant epilogue mirrors yolo_tpu/quant/fixed_point.py::_shift
// exactly, including shifts >= 32 (nearest -> 0, floor -> v >> 31) and
// negative (exact left) shifts; int32 adds wrap as XLA's do.

#pragma once

#include "int8_common.cuh"

namespace {

// A-tile gather modes of the conv kernel
constexpr int A_BYTE = 0;   // any C_in: one byte at a time
constexpr int A_VEC16 = 1;  // C_in % 16 == 0: 16-byte loads

struct ConvArgs {
  const int8_t* x[2];  // input parts, NHWC [B, H, W, cin[p]]
  const int8_t* w[2];  // HWIO [KS, KS, cin[p], Cout] of each part
  int cin[2];
  int acc_shift[2];  // each part's accumulator shift to the retune scale
  int nparts;
  const int* bias_rt;  // [Cout], at the retune scale
  int8_t* out;         // [B, Ho, Wo, Cout], or pooled [B, Ho/2, Wo/2, Cout]
  int B, H, W, Ho, Wo, Cout, stride, pad;
  Requant rq;
};

// The pooled form asks for three blocks per SM (at most 85 registers): the
// 64-column pooled 3x3 otherwise takes 92 and runs two, 11-19% slower on
// slim's conv3_2 and conv4_2 (nvcc -Xptxas -v and CUDA events on an H100).
template <int BN, bool POOL, int AMODE, int KS, bool TWO>
__global__ void __launch_bounds__(THREADS, POOL ? 3 : 1)
conv_requant_kernel(ConvArgs a) {
  using T = Tile<BN>;
  // Two stages of A and B tiles; after the K loop the same bytes stage the
  // int8 output tile (BM x BN <= (BM + BN) * LDS * 4 bytes for every BN)
  __shared__ __align__(16) unsigned smem[2 * T::STAGE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int Ho = a.Ho, Wo = a.Wo;
  const long long rows = (long long)a.B * Ho * Wo;  // POOL: 4 per output
  const long long row0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // ---- this thread's A row: GEMM row row0 + lr; of each 32-deep half of
  // the K tile it gathers the 16 bytes at [16 * lh, 16 * lh + 16)
  const int lr = tid >> 1, lh = tid & 1;
  const long long grow = row0 + lr;
  const bool row_ok = grow < rows;
  int b = 0, oy = 0, ox = 0;
  if (row_ok) {
    // 32-bit division: the wrapper keeps B * Ho * Wo below 2^31
    unsigned p = (unsigned)grow;
    int ph = 0;
    if (POOL) {
      ph = (int)(p & 3);
      p >>= 2;
    }
    const int wo = POOL ? Wo / 2 : Wo, ho = POOL ? Ho / 2 : Ho;
    ox = (int)(p % (unsigned)wo);
    p /= (unsigned)wo;
    oy = (int)(p % (unsigned)ho);
    b = (int)(p / (unsigned)ho);
    if (POOL) {
      oy = 2 * oy + (ph >> 1);
      ox = 2 * ox + (ph & 1);
    }
  }
  const int iy0 = oy * a.stride - a.pad, ix0 = ox * a.stride - a.pad;

  // the part being multiplied
  const int8_t* xp = a.x[0];
  int Cin = a.cin[0], K = KS * KS * Cin;
  // byte offset of channel c of tap `tap` of this row's pixel, or -1 in the
  // zero padding
  auto tap_offset = [&](int tap, int c) -> long long {
    const int y = iy0 + tap / KS, xx = ix0 + tap % KS;
    if (y < 0 || y >= a.H || xx < 0 || xx >= a.W) return -1;
    return (((long long)b * a.H + y) * a.W + xx) * Cin + c;
  };
  auto load_a = [&](int kt, unsigned (&areg)[8]) {
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
            const uint4 v = *reinterpret_cast<const uint4*>(xp + off);
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
            areg[e >> 2] |= ((unsigned)(uint8_t)xp[off]) << (8 * (e & 3));
        }
      }
    }
  };

  const int wm0 = (warp / T::WARPS_N) * T::WM;
  const int wn0 = (warp % T::WARPS_N) * T::WN;
  const bool nr = a.rq.nearest != 0;
  Acc<BN> acc, sum;
  zero_acc<BN>(acc);
  BTile<BN> bt{a.w[0], K, a.Cout, n0, (a.Cout & 3) == 0};
  gemm_mainloop<BN>(acc, smem, K, load_a, bt, wm0, wn0);
  // second part: same shift -> same accumulator; else shift part 1 now
  const bool split = TWO && a.acc_shift[1] != a.acc_shift[0];
  if (TWO) {
    if (split) {
#pragma unroll
      for (int i = 0; i < T::MF; ++i)
#pragma unroll
        for (int j = 0; j < T::NF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[i][j][e] = shift_i32(acc[i][j][e], a.acc_shift[0], nr);
            acc[i][j][e] = 0;
          }
    }
    xp = a.x[1];
    Cin = a.cin[1];
    K = KS * KS * Cin;
    bt.w = a.w[1];
    bt.K = K;
    gemm_mainloop<BN>(acc, smem, K, load_a, bt, wm0, wn0);
  }
  const int last_shift = TWO ? a.acc_shift[1] : a.acc_shift[0];

  // ---- epilogue: [pool max on int32] + requant into a staged int8 tile,
  // then 16-byte stores. Fragment layout: acc[.][.][0..1] at row gid,
  // columns 2*tig and 2*tig + 1; acc[.][.][2..3] at row gid + 8.
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
          int v = shift_i32(c[2 * hrow + e], last_shift, nr);
          if (TWO && split) v = add_wrap(v, sum[mf][nf][2 * hrow + e]);
          stage[ol * BN + cl + e] =
              co < a.Cout ? a.rq(add_wrap(v, a.bias_rt[co])) : (int8_t)0;
        }
      }
    }
  }
  __syncthreads();
  store_tile(stage, BN, POOL ? BM / 4 : BM, a.out, POOL ? row0 / 4 : row0,
             POOL ? rows / 4 : rows, a.Cout, n0, min(BN, a.Cout - n0));
}

template <int BN, bool POOL, int AMODE, int KS, bool TWO>
void launch_conv(const ConvArgs& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.Ho * a.Wo;  // POOL: 4 per output
  dim3 grid((unsigned)((rows + BM - 1) / BM),
            (unsigned)((a.Cout + BN - 1) / BN));
  conv_requant_kernel<BN, POOL, AMODE, KS, TWO>
      <<<grid, THREADS, 0, stream>>>(a);
}

}  // namespace
