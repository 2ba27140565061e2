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
// On the TPU they differ in how the matmul operands were assembled in VMEM
// (dy views + rolls, a 16*C_in phase-packed col, an in-VMEM im2col). Here
// they are two implicit GEMMs on the tensor cores: the conv kernel of
// int8_conv.cuh (its note says what bounds it and what the design does
// about that), and
//   pool_s2d: rows = pooled pixels, depth = the pixel's 4x4 input window,
//             which in the s2d layout is two contiguous runs of 8*C_in
//             bytes (4-byte loads), columns = 4*C_out phase-packed weights
//             (column 4*co + phase; built per block in shared memory), the
//             pool max taken over each column quad - the TPU kernel's
//             [16*C_in, 4*C_out] GEMM, without its col tensor in HBM.

#include "int8_conv.cuh"

namespace {

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
                        int Cout, int acc_shift, Requant rq) {
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
  const bool nr = rq.nearest != 0;

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
    Acc<BN> acc;
    zero_acc<BN>(acc);

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
              co < Cout ? rq(add_wrap(shift_i32(v[hrow], acc_shift, nr),
                                      bias_rt[co]))
                        : (int8_t)0;
        }
      }
    }
    __syncthreads();
    store_tile(stage, BN / 4, BM, out, row0, rows, Cout, n0 >> 2,
               min(BN, N - n0) >> 2);
  }
}

template <int BN, bool POOL>
void dispatch_conv_a(const ConvArgs& a, bool vec16, cudaStream_t st) {
  if (vec16)
    launch_conv<BN, POOL, A_VEC16, 3, false>(a, st);
  else
    launch_conv<BN, POOL, A_BYTE, 3, false>(a, st);
}

template <bool POOL>
void dispatch_conv(const ConvArgs& a, bool vec16, cudaStream_t st) {
  // 64 columns at most: a 128-wide tile needs so many registers that only
  // one block fits on an SM, and its load latency goes unhidden
  if (a.Cout <= 16)
    dispatch_conv_a<16, POOL>(a, vec16, st);
  else if (a.Cout <= 32)
    dispatch_conv_a<32, POOL>(a, vec16, st);
  else
    dispatch_conv_a<64, POOL>(a, vec16, st);
}

template <int BN>
int launch_pool_s2d(const int8_t* x, const int8_t* w, const int* bias,
                    int8_t* out, int B, int H, int W, int Cin, int Cout,
                    int acc_shift, const Requant& rq, cudaStream_t stream) {
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
      x, w, bias, out, B, H, W, Cin, Cout, acc_shift, rq);
  return 0;
}

int dispatch_pool_s2d(const int8_t* x, const int8_t* w, const int* bias,
                      int8_t* out, int B, int H, int W, int Cin, int Cout,
                      int acc_shift, const Requant& rq, cudaStream_t st) {
  if (4 * Cout <= 64)
    return launch_pool_s2d<64>(x, w, bias, out, B, H, W, Cin, Cout,
                               acc_shift, rq, st);
  return launch_pool_s2d<128>(x, w, bias, out, B, H, W, Cin, Cout, acc_shift,
                              rq, st);
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
  // slope 0.125 = 8192 / 2^16; no activation = slope 1
  const Requant rq{out_shift, leaky ? 8192 : 65536, nearest};
  if (s2d) {
    if (!pool) return (int)cudaErrorInvalidValue;
    const int rc = dispatch_pool_s2d(xi, wi, bi, oi, B, H, W, Cin, Cout,
                                     acc_shift, rq, st);
    if (rc != 0) return rc;
  } else {
    ConvArgs a{{xi, nullptr}, {wi, nullptr}, {Cin, 0}, {acc_shift, 0}, 1,
               bi, oi, B, H, W, H, W, Cout, 1, 1, rq};
    if (pool)
      dispatch_conv<true>(a, Cin % 16 == 0, st);
    else
      dispatch_conv<false>(a, Cin % 16 == 0, st);
  }
  return (int)cudaGetLastError();
}

const char* yolo_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
