// Bare int8 GEMM, for Hopper (sm_90a): int8 A [M, K] x int8 B [K, N] ->
// int32 C [M, N], both row-major. Plain C interface, loaded with ctypes by
// yolo_tpu_torch/kernels/int8_gemm.py.
//
// Replaces the Pallas TPU kernel K5, pallas_gemm.kernel of
// scripts/bench_int8_ceiling.py: the int8 ceiling probe, a tiled matmul
// with an int32 accumulator carried over its sequential K grid axis. Here
// blocks run in parallel in no order, so each block owns its output tile
// and loops over all of K itself, with the accumulator in registers.
//
// What bounds it on an H100: 2*M*N*K operations against M*K + K*N + 4*M*N
// bytes; at the probe's 8192^3 that is ~1.1 TOP over ~0.4 GB, bound by
// operations (1,979 dense int8 TOPS; 3.35 TB/s). The tile main loop is the
// one the conv kernels use (int8_common.cuh: 128 x 64 tiles on mma.sync
// m16n8k32, two shared-memory stages, A rows read with 16-byte loads when
// K % 16 == 0), so the probe measures the ceiling of that design, the
// yardstick for the conv kernels; wgmma + TMA is the step beyond it.

#include "int8_common.cuh"

namespace {

constexpr int GBN = 64;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
               int* __restrict__ C, int M, int N, int K) {
  using T = Tile<GBN>;
  __shared__ __align__(16) unsigned smem[2 * T::STAGE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int lr = tid >> 1, lh = tid & 1;
  const long long row0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * GBN;
  const long long r = row0 + lr;
  const bool row_ok = r < M;
  const int8_t* arow = A + r * K;

  auto load_a = [&](int kt, unsigned (&areg)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) areg[i] = 0;
    if (!row_ok) return;
    if (VEC) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k0 = kt + 32 * q + 16 * lh;
        if (k0 < K) {
          const uint4 v = *reinterpret_cast<const uint4*>(arow + k0);
          areg[4 * q + 0] = v.x;
          areg[4 * q + 1] = v.y;
          areg[4 * q + 2] = v.z;
          areg[4 * q + 3] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int k = kt + 32 * (e >> 4) + 16 * lh + (e & 15);
        if (k < K)
          areg[e >> 2] |= ((unsigned)(uint8_t)arow[k]) << (8 * (e & 3));
      }
    }
  };

  const int wm0 = (warp / T::WARPS_N) * T::WM;
  const int wn0 = (warp % T::WARPS_N) * T::WN;
  Acc<GBN> acc;
  zero_acc<GBN>(acc);
  BTile<GBN> bt{B, K, N, n0, (N & 3) == 0};
  gemm_mainloop<GBN>(acc, smem, K, load_a, bt, wm0, wn0);

  // fragment: acc[.][.][0..1] at row gid, columns 2*tig and 2*tig + 1;
  // acc[.][.][2..3] at row gid + 8
#pragma unroll
  for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < T::NF; ++nf)
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const long long row = row0 + wm0 + 16 * mf + gid + 8 * hrow;
        const int col = n0 + wn0 + 8 * nf + 2 * tig;
        if (row >= M) continue;
        int* dst = C + row * N + col;
        const int* c = &acc[mf][nf][2 * hrow];
        if ((N & 1) == 0 && col + 1 < N) {
          *reinterpret_cast<int2*>(dst) = make_int2(c[0], c[1]);
        } else {
          if (col < N) dst[0] = c[0];
          if (col + 1 < N) dst[1] = c[1];
        }
      }
}

}  // namespace

extern "C" {

// A: int8 [M, K] row-major (16-byte aligned when K % 16 == 0), B: int8
// [K, N] row-major (4-byte aligned), C: int32 [M, N] (8-byte aligned).
// Returns cudaGetLastError() after the launch.
int yolo_int8_gemm(const void* A, const void* B, void* C, int M, int N,
                   int K, void* stream) {
  if (M < 0 || N < 0 || K < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + GBN - 1) / GBN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(B);
  int* c = static_cast<int*>(C);
  if (K % 16 == 0)
    gemm_s8_kernel<true><<<grid, THREADS, 0, st>>>(a, b, c, M, N, K);
  else
    gemm_s8_kernel<false><<<grid, THREADS, 0, st>>>(a, b, c, M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
