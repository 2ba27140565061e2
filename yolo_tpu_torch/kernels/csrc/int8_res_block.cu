// Fused darknet53 residual block, for Hopper (sm_90a): int8 [B, H, W, C]
// -> 1x1 conv + requant (C -> Cmid) -> 3x3 conv (stride 1, pad 1) + requant
// (Cmid -> C) -> [residual add with the input + requant] -> int8
// [B, H, W, C], in one kernel. Plain C interface, loaded with ctypes by
// yolo_tpu_torch/kernels/int8_conv.py (int8_res_block).
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
// TOPS) at every darknet53 stage - if the mid activation y1 stays on chip.
// The design keeps it there: each block owns a spatial tile of one image
// (up to 16 x 16 output pixels) and
//   1. computes y1 for the tile plus a one-pixel halo (the 1x1 conv of the
//      halo pixels, recomputed by the neighbouring tiles) into shared
//      memory, zero outside the image (the 3x3 pads y1 with zeros, not
//      with requant(bias)), as the Pallas kernel masks it;
//   2. runs the 3x3 as an implicit GEMM whose A tile is gathered from
//      that shared-memory y1 (depth 9 * Cmid in (dy, dx, c) order = the
//      HWIO weights), looping over C in 64-column tiles inside the block
//      so y1 is computed once;
//   3. applies the requant in registers, stages the int8 tile in shared
//      memory, and adds the residual while storing 16 bytes at a time.
// Only x is read and only the block output written in device memory. Both
// GEMMs are 128-row tiles on mma.sync m16n8k32 with two shared-memory
// stages (int8_common.cuh); wgmma and TMA are the next step. Shared memory
// holds y1 ((T+2)^2 * Cmid bytes, 115 KB for the whole 13 x 13 image at
// Cmid 512) plus the two stages (30 KB).
//
// The shifts follow yolo_tpu/quant/fixed_point.py::_shift, including the
// s >= 32 branch that the Pallas kernel's _shift_round_nearest lacks.

#include "int8_common.cuh"

namespace {

constexpr int BN2 = 64;  // 3x3 output columns per tile

struct ResArgs {
  const int8_t* x;        // [B, H, W, C]
  const int8_t* w1;       // [C, Cmid]
  const int* b1;          // [Cmid], at conv1's retune scale
  const int8_t* w2;       // HWIO [3, 3, Cmid, C]
  const int* b2;          // [C], at conv2's retune scale
  int8_t* out;            // [B, H, W, C]
  int B, H, W, C, Cmid;
  int TH, TW;             // output tile (the edge tiles may be smaller)
  int acc1, acc2;         // accumulator shifts to the retune scales
  Requant rq1, rq2;
  int res;                // 1: residual add
  int sh_a, sh_b, sh_out;  // residual: align conv2 out, align x, requant
};

template <int BN1>
__global__ void __launch_bounds__(THREADS) res_block_kernel(ResArgs a) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int lr = tid >> 1, lh = tid & 1;

  // ---- this block's tile
  const int ntx = (a.W + a.TW - 1) / a.TW, nty = (a.H + a.TH - 1) / a.TH;
  const int b = blockIdx.x / (ntx * nty);
  const int t = blockIdx.x - b * ntx * nty;
  const int ty0 = (t / ntx) * a.TH, tx0 = (t % ntx) * a.TW;
  const int th = min(a.TH, a.H - ty0), tw = min(a.TW, a.W - tx0);
  const int hw = tw + 2;                       // halo tile width
  const int P1 = (th + 2) * hw, P2 = th * tw;  // halo / output pixels

  // y1 [P1][Cmid] int8, then the two GEMM stages (int32 words)
  int8_t* y1 = reinterpret_cast<int8_t*>(dsmem);
  const int y1_bytes = ((a.TH + 2) * (a.TW + 2) * a.Cmid + 15) & ~15;
  unsigned* smem = reinterpret_cast<unsigned*>(dsmem + y1_bytes);
  const long long img = (long long)b * a.H * a.W;  // first pixel of image b

  // ---- 1. y1 = requant(x[halo] * w1), zero outside the image
  {
    using T = Tile<BN1>;
    const int wm0 = (warp / T::WARPS_N) * T::WM;
    const int wn0 = (warp % T::WARPS_N) * T::WN;
    for (int m0 = 0; m0 < P1; m0 += BM) {
      // this thread's A row: halo pixel m0 + lr
      const int p = m0 + lr;
      const int hy = p / hw, hx = p - (p / hw) * hw;
      const int iy = ty0 - 1 + hy, ix = tx0 - 1 + hx;
      const bool ok = p < P1 && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
      const int8_t* xrow = a.x + (img + (long long)iy * a.W + ix) * a.C;
      auto load_a = [&](int kt, unsigned (&areg)[8]) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k0 = kt + 32 * q + 16 * lh;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (ok && k0 < a.C) v = *reinterpret_cast<const uint4*>(xrow + k0);
          areg[4 * q + 0] = v.x;
          areg[4 * q + 1] = v.y;
          areg[4 * q + 2] = v.z;
          areg[4 * q + 3] = v.w;
        }
      };
      for (int n0 = 0; n0 < a.Cmid; n0 += BN1) {
        Acc<BN1> acc;
        zero_acc<BN1>(acc);
        BTile<BN1> bt{a.w1, a.C, a.Cmid, n0, true};
        gemm_mainloop<BN1>(acc, smem, a.C, load_a, bt, wm0, wn0);
        const bool nr = a.rq1.nearest != 0;
#pragma unroll
        for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < T::NF; ++nf)
#pragma unroll
            for (int hrow = 0; hrow < 2; ++hrow) {
              const int pr = m0 + wm0 + 16 * mf + gid + 8 * hrow;
              if (pr >= P1) continue;
              const int ry = pr / hw, rx = pr - (pr / hw) * hw;
              const int gy = ty0 - 1 + ry, gx = tx0 - 1 + rx;
              const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int co = n0 + wn0 + 8 * nf + 2 * tig + e;
                const int v = shift_i32(acc[mf][nf][2 * hrow + e], a.acc1, nr);
                y1[pr * a.Cmid + co] = in ? a.rq1(add_wrap(v, a.b1[co]))
                                          : (int8_t)0;
              }
            }
      }
    }
  }
  __syncthreads();

  // ---- 2. the 3x3 over y1, 3. requant + residual
  {
    using T = Tile<BN2>;
    const int wm0 = (warp / T::WARPS_N) * T::WM;
    const int wn0 = (warp % T::WARPS_N) * T::WN;
    const int K = 9 * a.Cmid;
    const bool nr = a.rq2.nearest != 0;
    int8_t* stage = reinterpret_cast<int8_t*>(smem);
    for (int m0 = 0; m0 < P2; m0 += BM) {
      const int p = m0 + lr;
      const bool ok = p < P2;
      const int py = p / tw, px = p - (p / tw) * tw;
      // y1 byte offset of tap (0, 0) of this row's output pixel
      const int base = (py * hw + px) * a.Cmid;
      auto load_a = [&](int kt, unsigned (&areg)[8]) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k0 = kt + 32 * q + 16 * lh;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (ok && k0 < K) {
            const int tap = k0 / a.Cmid, c = k0 - tap * a.Cmid;
            const int dy = tap / 3, dx = tap - 3 * (tap / 3);
            v = *reinterpret_cast<const uint4*>(
                y1 + base + (dy * hw + dx) * a.Cmid + c);
          }
          areg[4 * q + 0] = v.x;
          areg[4 * q + 1] = v.y;
          areg[4 * q + 2] = v.z;
          areg[4 * q + 3] = v.w;
        }
      };
      for (int n0 = 0; n0 < a.C; n0 += BN2) {
        Acc<BN2> acc;
        zero_acc<BN2>(acc);
        BTile<BN2> bt{a.w2, K, a.C, n0, true};
        gemm_mainloop<BN2>(acc, smem, K, load_a, bt, wm0, wn0);
#pragma unroll
        for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < T::NF; ++nf)
#pragma unroll
            for (int hrow = 0; hrow < 2; ++hrow) {
              const int rl = wm0 + 16 * mf + gid + 8 * hrow;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int cl = wn0 + 8 * nf + 2 * tig + e;
                const int v = shift_i32(acc[mf][nf][2 * hrow + e], a.acc2, nr);
                stage[rl * BN2 + cl] = a.rq2(add_wrap(v, a.b2[n0 + cl]));
              }
            }
        __syncthreads();
        // store 16 bytes at a time, with the residual add on the way
        for (int i = tid; i < BM * (BN2 / 16); i += THREADS) {
          const int rl = i / (BN2 / 16), ch = i - rl * (BN2 / 16);
          const int po = m0 + rl;
          if (po >= P2) continue;
          const int oy = po / tw, ox = po - (po / tw) * tw;
          const long long off =
              (img + (long long)(ty0 + oy) * a.W + tx0 + ox) * a.C + n0 +
              16 * ch;
          uint4 o = *reinterpret_cast<const uint4*>(stage + rl * BN2 + 16 * ch);
          if (a.res) {
            const uint4 xv = *reinterpret_cast<const uint4*>(a.x + off);
            int8_t* ob = reinterpret_cast<int8_t*>(&o);
            const int8_t* xb = reinterpret_cast<const int8_t*>(&xv);
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int va = (int)((unsigned)(int)ob[j] << a.sh_a);
              const int vb = (int)((unsigned)(int)xb[j] << a.sh_b);
              const int s = shift_i32(add_wrap(va, vb), a.sh_out, nr);
              ob[j] = (int8_t)min(max(s, -128), 127);
            }
          }
          *reinterpret_cast<uint4*>(a.out + off) = o;
        }
        __syncthreads();
      }
    }
  }
}

int res_block_smem(int th, int tw, int cmid) {
  const int y1 = ((th + 2) * (tw + 2) * cmid + 15) & ~15;
  return y1 + 2 * Tile<BN2>::STAGE * 4;
}

template <int BN1>
int launch_res_block(const ResArgs& a, int smem_bytes, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      res_block_kernel<BN1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = ((a.H + a.TH - 1) / a.TH) * ((a.W + a.TW - 1) / a.TW);
  res_block_kernel<BN1>
      <<<(unsigned)(a.B * ntiles), THREADS, smem_bytes, st>>>(a);
  return 0;
}

}  // namespace

extern "C" {

// x: int8 NHWC [B, H, W, C], 16-byte aligned, C % 64 == 0; w1: int8
// [C, Cmid] (Cmid % 32 == 0), w2: int8 HWIO [3, 3, Cmid, C], both 4-byte
// aligned; b1_rt / b2_rt: int32 at the two retune scales; out: int8
// [B, H, W, C], 16-byte aligned. tile_h x tile_w output pixels per block,
// whose y1 takes (tile_h + 2) * (tile_w + 2) * Cmid bytes of shared memory
// beside the two 15 KB GEMM stages (at most 227 KB in all).
// slope_num: the LeakyReLU slope of both convs * 65536 (8192: 0.125;
// 65536: none).
// res: add the residual: out = clamp(shift((o << sh_a) + (x << sh_b),
// sh_out)). Returns the launch's error code (cudaGetLastError()).
int yolo_int8_res_block(const void* x, const void* w1, const void* b1_rt,
                        const void* w2, const void* b2_rt, void* out, int B,
                        int H, int W, int C, int Cmid, int tile_h, int tile_w,
                        int acc1, int out1, int acc2, int out2,
                        int slope_num, int nearest, int res, int sh_a,
                        int sh_b, int sh_out, void* stream) {
  if (C % 64 || Cmid % 32 || tile_h < 1 || tile_w < 1)
    return (int)cudaErrorInvalidValue;
  ResArgs a{static_cast<const int8_t*>(x),
            static_cast<const int8_t*>(w1),
            static_cast<const int*>(b1_rt),
            static_cast<const int8_t*>(w2),
            static_cast<const int*>(b2_rt),
            static_cast<int8_t*>(out),
            B, H, W, C, Cmid, tile_h, tile_w, acc1, acc2,
            Requant{out1, slope_num, nearest},
            Requant{out2, slope_num, nearest},
            res, sh_a, sh_b, sh_out};
  const int smem = res_block_smem(tile_h, tile_w, Cmid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = Cmid % 64 ? launch_res_block<32>(a, smem, st)
                           : launch_res_block<64>(a, smem, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
