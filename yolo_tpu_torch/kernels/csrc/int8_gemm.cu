// Bare int8 GEMM, for Hopper (sm_90a): int8 A [M, K] x int8 B -> int32
// C [M, N], with B given K-major as Bt [N, K] (both operands K-major:
// wgmma takes no transposed 8-bit operand). Plain C interface, loaded
// with ctypes by yolo_tpu_torch/kernels/int8_gemm.py, which pads K to a
// multiple of 16 (TMA's row stride) with zeros.
//
// Replaces the Pallas TPU kernel K5, pallas_gemm.kernel of
// scripts/bench_int8_ceiling.py: the int8 ceiling probe, a tiled matmul
// with an int32 accumulator carried over its sequential K grid axis. Here
// blocks run in parallel in no order, so each block owns its output tile
// and loops over all of K itself, with the accumulator in registers.
//
// What bounds it on an H100: 2*M*N*K operations against M*K + K*N + 4*M*N
// bytes; at the probe's 8192^3 that is ~1.1 TOP over ~0.4 GB, bound by
// operations (1,979 dense int8 TOPS; 3.35 TB/s). The design is the
// Hopper one (int8_wgmma.cuh): a 128 x 256 output tile per block, K in
// 128-byte steps through a 4-stage shared-memory ring that TMA fills
// (48 KB a stage, 128-byte swizzle, the M / N / K edges zero-filled out of
// bounds), one producer warpgroup (one thread starts the loads; its
// registers handed to the consumers with setmaxnreg) and two consumer
// warpgroups, each running wgmma m64n256k32 from shared-memory
// descriptors on its 64 rows, one K step behind the last retired.

#include <climits>

#include "int8_wgmma.cuh"

namespace {

constexpr int GM = 128, GN = 256;       // output tile
constexpr int GSTAGES = 4;              // ring depth
constexpr int A_BYTES = GM * SW;        // 16 KB
constexpr int B_BYTES = GN * SW;        // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int GTHREADS = 384;           // 2 consumer + 1 producer warpgroup
constexpr int GEMM_SMEM = GSTAGES * STAGE_BYTES + 2 * GSTAGES * 8 + 1024;

__global__ void __launch_bounds__(GTHREADS, 1)
gemm_s8_wgmma(const __grid_constant__ CUtensorMap tm_a,
              const __grid_constant__ CUtensorMap tm_b, int* __restrict__ C,
              int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  // the swizzled tiles need 1024-byte alignment
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dsmem) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + GSTAGES * STAGE_BYTES);
  const Ring ring{bars, bars + GSTAGES, GSTAGES};
  const int tid = threadIdx.x, wg = tid / 128;
  // a 1-D grid over the output tiles, N tiles fastest (grid.y would cap
  // the M tiles at 65,535)
  const int ntn = (N + GN - 1) / GN;
  const int m0 = (int)(blockIdx.x / ntn) * GM;
  const int n0 = (int)(blockIdx.x % ntn) * GN;
  const int nk = (K + SW - 1) / SW;

  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      tma_prefetch_map(&tm_a);
      tma_prefetch_map(&tm_b);
      for (int i = 0; i < nk; ++i) {
        ring.producer_acquire(i, STAGE_BYTES);
        unsigned char* st = smem + ring.stage(i) * STAGE_BYTES;
        uint64_t* full = &ring.full[ring.stage(i)];
        tma_load_2d(st, &tm_a, full, i * SW, m0);
        tma_load_2d(st + A_BYTES, &tm_b, full, i * SW, n0);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 64
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // zeroed here, so ptxas serializes the wgmmas it sees defined by other
    // instructions (advisory C7515); on an H100 that measured faster than
    // starting each tile with scale-d = 0
    int acc[128];
#pragma unroll
    for (int e = 0; e < 128; ++e) acc[e] = 0;
    for (int i = 0; i < nk; ++i) {
      ring.consumer_wait(i);
      const unsigned char* st = smem + ring.stage(i) * STAGE_BYTES;
      const uint64_t da = desc_sw128(st + wg * 64 * SW);
      const uint64_t db = desc_sw128(st + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < SW / 32; ++k)
        mma_ss_n256(acc, da + 2 * k, db + 2 * k, 1);
      wgmma_commit();
      // keep this step's wgmmas in flight; the previous step's are retired
      wgmma_wait<1>();
      if (i > 0) ring.consumer_release(i - 1);
    }
    wgmma_wait<0>();

    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int gid = lane >> 2, tig = lane & 3;
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wg * 64 + warp * 16 + gid + 8 * h;
        if (row >= M || col >= N) continue;
        int* dst = C + (long long)row * N + col;
        const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (pairs) {
          *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
        } else {
          dst[0] = v0;
          if (col + 1 < N) dst[1] = v1;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// A: int8 [M, K] row-major, Bt: int8 [N, K] row-major (B's K-major form),
// both 16-byte aligned with K % 16 == 0; C: int32 [M, N] (8-byte aligned);
// M and N at most 2^31 - 256. Returns the first CUDA error of setting up
// or launching the kernel.
int yolo_int8_gemm(const void* A, const void* Bt, void* C, int M, int N,
                   int K, void* stream) {
  const long long tiles =
      (M + GM - 1LL) / GM * ((N + GN - 1LL) / GN);
  if (M < 1 || N < 1 || M > INT_MAX - GN || N > INT_MAX - GN || K < 16 ||
      K % 16 || tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;
  const cuuint32_t box_a[2] = {SW, GM}, box_b[2] = {SW, GN};
  const cuuint64_t dims_a[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dims_b[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t stride[1] = {(cuuint64_t)K};
  int rc = make_map(&tm_a, A, 2, dims_a, stride, box_a);
  if (rc == 0) rc = make_map(&tm_b, Bt, 2, dims_b, stride, box_b);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_s8_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;
  gemm_s8_wgmma<<<(unsigned)tiles, GTHREADS, GEMM_SMEM,
                  static_cast<cudaStream_t>(stream)>>>(tm_a, tm_b,
                                                       static_cast<int*>(C),
                                                       M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
