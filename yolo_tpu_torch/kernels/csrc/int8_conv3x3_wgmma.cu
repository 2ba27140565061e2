// Int8 conv3x3 (stride 1, pad 1) + fixed-point requant, for Hopper
// (sm_90a), on wgmma fed by a TMA ring: int8 NHWC [B, H, W, Cin] at scale
// 2^sa_in, Cin % 32 == 0 -> int8 [B, H, W, Cout], any Cout >= 1. Plain C
// interface, loaded with ctypes by yolo_tpu_torch/kernels/int8_conv.py,
// whose int8_conv3x3_requant and int8_conv_requant send every conv of this
// shape here (conv3x3_wgmma_route); the weights are packed K-major once per
// model (pack_conv3x3_weights) as [Cout, 9 * Cin] in (dy, dx, c) order.
//
// Replaces the Pallas TPU kernel K1 _conv_kernel / int8_conv3x3_requant of
// yolo_tpu/kernels/int8_conv.py (all six K1 layers of slim_yolo_v2), and
// XLA's integer conv in yolo_tpu/quant/fixed_point.py::int_conv_requant at
// the yolo_v3 head's nine stride-1 3x3s. The leaky slope is 0.125, none,
// or any Q16 rational; both roundings.
//
// What bounds it on an H100: 18 * Cin * Cout ops per output pixel against
// Cin + Cout bytes in and out, so every routed layer with Cin >= 64 is
// bound by operations (1,979 dense int8 TOPS) and slim's conv3_1 (32 ->
// 64, ~385 ops per byte) by bytes (3.35 TB/s). The design is the 3x3
// phase of the fused residual block (int8_res_block.cu), with its input
// loaded instead of computed; its pieces are shared through
// int8_wgmma_conv.cuh. Each block owns a TH x TW output tile of one image
// (plan_tile: up to 26 x 26, halved until it fits) and
//   1. copies the tile plus a one-pixel halo of x, all Cin channels, into
//      shared memory, zero outside the image (the conv's padding), rows
//      Cin + 16 bytes apart so that the 8 rows of an ldmatrix fall in 8
//      different 16-byte bank groups. The copy is cp.async, 16 bytes per
//      thread (zero-filled outside the image), not 4-D TMA boxes: the
//      padded rows let the 3x3 phase below run unchanged, where a TMA box
//      (<= 128 channels of one 128-byte swizzled row) would need a swizzle
//      XOR in every ldmatrix address and one box per 128 channels. The
//      producer warp's first weight stages are in flight meanwhile;
//   2. runs the 3x3 as an implicit GEMM [tile pixels, 9 * Cin] x
//      [9 * Cin, Cout] on wgmma (RS): each consumer warpgroup loads its A
//      fragments straight from the tile with ldmatrix, taps outside and
//      channels inside, so the tap offsets are additions; the weights
//      stream through a shared-memory ring of 3-8 stages that TMA fills
//      (128-byte swizzle, full / empty mbarriers), rows past Cout
//      zero-filled, so Cout = 35 runs in one 64-column tile;
//   3. requantizes in registers (every shift one branch-free form set up
//      on the host), stages 64 x 64 bytes per warpgroup in shared memory
//      and stores 16 bytes at a time (byte by byte, masked at Cout, where
//      Cout % 16 != 0 leaves the output rows unaligned).
// Three consumer warpgroups share each weight tile where Cout % 128 == 0
// (a producer warpgroup hands them its registers); else two, with a
// 64-column tile and one producer warp, and two blocks per SM where the
// tile and ring fit in half an SM.
//
// The shifts follow yolo_tpu/quant/fixed_point.py::_shift, including
// s >= 32 and s < 0.

#include "int8_wgmma_conv.cuh"

namespace {

template <int BN>
struct ConvCfg {
  // consumer warpgroups, each owning 64 rows of an M step
  static constexpr int NWG = BN == 64 ? 2 : 3;
  static constexpr int CONSUMERS = 128 * NWG;
  // + the producer: a whole warpgroup that hands its registers to the
  // consumers (setmaxnreg) in the wide form, one warp in the narrow form
  static constexpr int THREADS = NWG == 3 ? 512 : CONSUMERS + 32;
  static constexpr int MIN_BLOCKS = BN == 64 ? 2 : 1;
  // a ring slot: two weight tiles (BN rows each), one 256-deep K step
  static constexpr int SLOT = 2 * BN * SW;
};

struct Conv3Args {
  const int8_t* x;  // [B, H, W, Cin]
  const int* bias;  // [Cout rounded up to 128], retune scale, 0 past Cout
  int8_t* out;      // [B, H, W, Cout]
  int B, H, W, Cin, Cout;
  int TH, TW;    // output tile (the edge tiles may be smaller)
  int stages;    // ring depth, 3..MAX_STAGES
  Epi epi;
};

// 16 bytes global -> shared, the first `bytes` (0 or 16) of them read, the
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

template <int BN, bool SHORT>
__global__ void __launch_bounds__(ConvCfg<BN>::THREADS,
                                  ConvCfg<BN>::MIN_BLOCKS)
conv3x3_wgmma(const __grid_constant__ CUtensorMap tm_w, Conv3Args a) {
  using Cfg = ConvCfg<BN>;
  constexpr int NWG = Cfg::NWG, CONSUMERS = Cfg::CONSUMERS;
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dsmem) + 1023) & ~uintptr_t(1023));
  const int HW = a.TW + 2, HH = a.TH + 2, S = y1_stride(a.Cin);
  int8_t* xt = reinterpret_cast<int8_t*>(smem + a.stages * Cfg::SLOT);
  int8_t* stg_all = xt + halo_bytes(a.TH, a.TW, a.Cin);
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
  const int K = 9 * a.Cin, nk = (K + 2 * SW - 1) / (2 * SW);
  const int nn = (a.Cout + BN - 1) / BN;
  const int nc = (a.TH * a.TW + 64 * NWG - 1) / (64 * NWG);

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
      tma_prefetch_map(&tm_w);
      int i = 0;
      for (int c = 0; c < nc; ++c)
        for (int n = 0; n < nn; ++n)
          for (int k = 0; k < nk; ++k, ++i) {
            const bool two = k * 2 * SW + SW < K;
            ring.producer_acquire(i, (two ? 2 : 1) * BN * SW);
            unsigned char* st = smem + ring.stage(i) * Cfg::SLOT;
            uint64_t* full = &ring.full[ring.stage(i)];
            tma_load_2d(st, &tm_w, full, k * 2 * SW, n * BN);
            if (two)
              tma_load_2d(st + BN * SW, &tm_w, full, k * 2 * SW + SW, n * BN);
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

  // ---- 1. the tile and its halo of x, zero outside the image
  {
    const int chunks = a.Cin / 16;  // 16-byte chunks per pixel
    for (int e = tid; e < HH * HW * chunks; e += CONSUMERS) {
      const int p = e / chunks, q = e - p * chunks;
      const int hy = p / HW, hx = p - hy * HW;
      const int gy = ty0 - 1 + hy, gx = tx0 - 1 + hx;
      const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const int8_t* src =
          in ? a.x + (img + (long long)gy * a.W + gx) * a.Cin + 16 * q : a.x;
      cp_async16(xt + p * S + 16 * q, src, in ? 16 : 0);
    }
    cp_async_wait_all();
  }
  named_sync(1, CONSUMERS);  // the tile complete

  // ---- 2. the 3x3 over the tile, 3. requant
  const int P = a.TH * a.TW;     // rows of the nominal tile
  const int P_live = th * a.TW;  // rows from here on lie below the image
  int8_t* stg = stg_all + wg * STG_BYTES;
  int i = 0;
  for (int c = 0; c < nc; ++c) {
    const int p0 = (c * NWG + wg) * 64;
    const bool active = p0 < P_live;
    // this lane's ldmatrix row: output pixel r of the tile
    int r = p0 + warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    if (r >= P) r = 0;
    const int py = r / a.TW, px = r - py * a.TW;
    const int8_t* arow = xt + (py * HW + px) * S + 16 * (lane >> 4);
    // the two 16-byte chunks this thread copies out: output byte offset of
    // their pixel, or -1 outside the image
    long long obase[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int po = p0 + ((ltid + 128 * q) >> 2);
      const int oy = po / a.TW, ox = po - oy * a.TW;
      obase[q] = oy < th && ox < tw
                     ? (img + (long long)(ty0 + oy) * a.W + tx0 + ox) * a.Cout
                     : -1;
    }
    for (int n = 0; n < nn; ++n) {
      int acc[BN / 2];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
      // (tap, channel) of the next 32-deep K step: tile offset tap_off +
      // ch, tap_off = (dy * HW + dx) * S
      int tap_off = 0, ch = 0, dx = 0;
      for (int k = 0; k < nk; ++k, ++i) {
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
              if (k * 2 * SW + half * SW + 32 * j < K) {
                ldmatrix_x4(af[j], arow + tap_off + ch);
                ch += 32;
                if (ch == a.Cin) {
                  ch = 0;
                  if (++dx == 3) {
                    dx = 0;
                    tap_off += (HW - 2) * S;
                  } else {
                    tap_off += S;
                  }
                }
              }
            }
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < SW / 32; ++j)
              if (k * 2 * SW + half * SW + 32 * j < K)
                mma_rs<BN>(acc, af[j], db + ((half * BN * SW + j * 32) >> 4));
            wgmma_commit();
          }
          wgmma_wait<0>();
        }
        ring.consumer_release(i);
      }
      if (!active) continue;
      // 64 columns at a time through the warpgroup's staging tile
#pragma unroll
      for (int pass = 0; pass < BN / 64; ++pass) {
        const int col0 = n * BN + pass * 64;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cl = 8 * j + 2 * tig;
          const int2 bias = *reinterpret_cast<const int2*>(a.bias + col0 + cl);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int* v = &acc[4 * (8 * pass + j) + 2 * h];
            *reinterpret_cast<uint16_t*>(
                stg + stg_at(warp * 16 + gid + 8 * h, cl)) =
                pack2(a.epi.apply<SHORT>(v[0], bias.x),
                      a.epi.apply<SHORT>(v[1], bias.y));
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

// The form's layout for an H x W image of Cin channels: plan_tile's output
// tile and ring (int8_wgmma_conv.cuh), the ring in half an SM's shared
// memory for the two-block form.
template <int BN>
TilePlan plan(int H, int W, int Cin) {
  using Cfg = ConvCfg<BN>;
  return plan_tile(H, W, Cin, Cfg::SLOT, Cfg::NWG,
                   Cfg::MIN_BLOCKS == 2 ? HALF_SM_SMEM : MAX_SMEM);
}

constexpr int INFO_LEN = 9;

// Launches the form, or with `info` reports its layout there instead.
template <int BN, bool SHORT>
int launch_form(Conv3Args a, const void* wp, int* info, cudaStream_t st) {
  using Cfg = ConvCfg<BN>;
  const TilePlan p = plan<BN>(a.H, a.W, a.Cin);
  if (p.smem == 0) return (int)cudaErrorInvalidValue;
  a.TH = p.th;
  a.TW = p.tw;
  a.stages = p.stages;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgmma<BN, SHORT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (err != cudaSuccess) return (int)err;
  if (info != nullptr) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, conv3x3_wgmma<BN, SHORT>, Cfg::THREADS, p.smem);
    if (err != cudaSuccess) return (int)err;
    const int pixels = a.TH * a.TW;
    const int vals[INFO_LEN] = {a.TH,     a.TW,     p.smem, blocks,
                                BN,       Cfg::NWG, a.stages, pixels,
                                (pixels + 63) / 64 * 64};
    for (int k = 0; k < INFO_LEN; ++k) info[k] = vals[k];
    return 0;
  }
  CUtensorMap tm_w;
  const cuuint64_t K = 9 * (cuuint64_t)a.Cin;
  const cuuint64_t dims[2] = {K, (cuuint64_t)a.Cout}, strides[1] = {K};
  const cuuint32_t box[2] = {SW, BN};
  const int rc = make_map(&tm_w, wp, 2, dims, strides, box);
  if (rc != 0) return rc;
  const long long ntiles = (long long)((a.H + a.TH - 1) / a.TH) *
                           ((a.W + a.TW - 1) / a.TW);
  conv3x3_wgmma<BN, SHORT>
      <<<(unsigned)(a.B * ntiles), Cfg::THREADS, p.smem, st>>>(tm_w, a);
  return (int)cudaGetLastError();
}

// the 128-column form where Cout fills it, else the 64-column one
template <bool SHORT>
int dispatch(const Conv3Args& a, const void* wp, int* info,
             cudaStream_t st) {
  if (a.Cout % 128 == 0) return launch_form<128, SHORT>(a, wp, info, st);
  return launch_form<64, SHORT>(a, wp, info, st);
}

bool bad_shape(int H, int W, int Cin, int Cout) {
  return H < 1 || W < 1 || Cin < 32 || Cin % 32 || Cout < 1;
}

Conv3Args base_args(int H, int W, int Cin, int Cout) {
  Conv3Args a{};
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
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
// its output tile (plan; reported by yolo_int8_conv3x3_wgmma_info) and
// fails where no tile fits. Returns the first CUDA error of setting up or
// launching.
int yolo_int8_conv3x3_wgmma(const void* x, const void* wp,
                            const void* bias_rt, void* out, int B, int H,
                            int W, int Cin, int Cout, int acc_shift,
                            int out_shift, int slope_num, int nearest,
                            void* stream) {
  if (bad_shape(H, W, Cin, Cout) || B < 1) return (int)cudaErrorInvalidValue;
  Conv3Args a = base_args(H, W, Cin, Cout);
  a.x = static_cast<const int8_t*>(x);
  a.bias = static_cast<const int*>(bias_rt);
  a.out = static_cast<int8_t*>(out);
  a.B = B;
  a.epi = make_epi(acc_shift, out_shift, slope_num, nearest != 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (short_shift(acc_shift) && short_shift(out_shift))
    return dispatch<true>(a, wp, nullptr, st);
  return dispatch<false>(a, wp, nullptr, st);
}

// The kernel's layout for an H x W x Cin -> Cout conv: info[0..8] = tile
// height, tile width, dynamic shared memory bytes, resident blocks per SM,
// columns per weight tile (BN), consumer warpgroups, ring stages, pixels
// of a full tile, rows of the 64-row wgmma steps that a full tile runs.
// Returns 0, or an error code where the shape is not taken or no tile
// fits in shared memory.
int yolo_int8_conv3x3_wgmma_info(int H, int W, int Cin, int Cout,
                                 int* info) {
  if (bad_shape(H, W, Cin, Cout)) return (int)cudaErrorInvalidValue;
  return dispatch<true>(base_args(H, W, Cin, Cout), nullptr, info, nullptr);
}

}  // extern "C"
