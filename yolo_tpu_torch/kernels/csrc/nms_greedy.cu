// Class-aware greedy NMS keep mask, for Hopper (sm_90a): K score-ordered
// candidates of each image -> keep [B, K]. Plain C interface, loaded with
// ctypes by yolo_tpu_torch/kernels/__init__.py, launched from
// yolo_tpu_torch/ops/nms.py (the CUDA implementation of the op
// yolo_tpu_torch::greedy_nms_keep).
//
// Replaces no Pallas kernel: the JAX package runs greedy NMS as a
// lax.while_loop of Jacobi sweeps on the device (yolo_tpu/ops/nms.py,
// postprocess_jax), each sweep a [K] x [K, K] int8 product. The port's
// plain version runs the same sweeps as torch ops and reads a flag back
// to the host after each one; this kernel computes the sweeps' fixpoint in
// one launch, with no host read, so a detect fn can be captured in a CUDA
// graph or exported whole.
//
// keep_i = valid_i & !any_{j < i} (keep_j & same class & IoU(j, i) >
// thresh) has one solution, found in score order: the greedy scan. One
// block per image:
//   1. the K boxes, their areas, classes and valid flags go to shared
//      memory (25 bytes a candidate);
//   2. the warps build each valid candidate's suppression row as bits:
//      row i, word w, bit t is set where j = 32 w + t > i has i's class
//      and IoU(i, j) > thresh: i suppresses j if i is kept. Up to K x K/32
//      words (32 KB at K = 512, 128 KB at K = 1024), never in device
//      memory; the words below i's own are not made;
//   3. one warp scans i = 0..K-1 with a `removed` mask spread over its
//      lanes (lane l holds word l): keep_i = valid_i & !removed_i, and a
//      kept i ORs its row into `removed`.
// The IoU is computed op by op as torch's separate elementwise kernels
// compute it (areas (x2 - x1) * (y2 - y1); intersection sides clamped at
// 1e-28; inter / (area_i + area_j - inter)), each step rounded on its own
// (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn: nvcc would otherwise fuse
// a multiply and an add into an FMA), and compared with the threshold as
// a float32, as torch compares with a Python scalar: the keep mask equals
// the plain version's bit for bit.
//
// What bounds it on an H100: it reads 21 bytes and writes 1 a candidate
// (2.9 MB for 256 images of 512 candidates at 3.35 TB/s: ~0.9 us), and at
// most K^2 / 2 IoUs an image (33.5 M at that shape; an IEEE division
// each); the scan, K dependent steps of a few instructions, is the
// latency of one block. 256 blocks of 256 threads and 42 KB fit one wave
// (5 a multiprocessor by shared memory).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int NMS_THREADS = 256;
constexpr int NMS_MAX_K = 1024;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(i, j) > thresh with torch's order of operations: i is the row of
// the [K, K] IoU matrix, j its column
__device__ __forceinline__ bool overlaps(float4 bi, float ai, float4 bj,
                                         float aj, float thresh) {
  const float w = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)),
                        1e-28f);
  const float h = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)),
                        1e-28f);
  const float inter = __fmul_rn(w, h);
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(ai, aj), inter)) > thresh;
}

size_t nms_smem(int K) {
  const int words = (K + 31) / 32;
  return (size_t)K * (sizeof(float4) + sizeof(float) + sizeof(int) + 1) +
         (size_t)K * words * sizeof(unsigned);
}

__global__ void __launch_bounds__(NMS_THREADS)
nms_greedy_keep(const float4* __restrict__ boxes,
                const int* __restrict__ cls,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int K, float thresh) {
  extern __shared__ float4 smem[];
  const int words = (K + 31) / 32;
  float4* sbox = smem;
  unsigned* rows = reinterpret_cast<unsigned*>(sbox + K);
  float* sarea = reinterpret_cast<float*>(rows + (size_t)K * words);
  int* scls = reinterpret_cast<int*>(sarea + K);
  uint8_t* svalid = reinterpret_cast<uint8_t*>(scls + K);

  const size_t img = (size_t)blockIdx.x * K;
  for (int i = threadIdx.x; i < K; i += NMS_THREADS) {
    const float4 b = boxes[img + i];
    sbox[i] = b;
    sarea[i] = area(b);
    scls[i] = cls[img + i];
    svalid[i] = valid[img + i];
  }
  __syncthreads();

  // one warp a row, round robin, one word at a time: lane t tests
  // j = 32 w + t. Only the words from i's own on are made, and only for
  // valid rows: the scan reads no other (the bits of j <= i it ORs in are
  // of candidates already decided)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < K; i += NMS_THREADS / 32) {
    if (!svalid[i]) continue;
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    const int ci = scls[i];
    for (int w = i >> 5; w < words; ++w) {
      const int j = 32 * w + lane;
      bool s = false;
      if (j > i && j < K && scls[j] == ci)
        s = overlaps(bi, ai, sbox[j], sarea[j], thresh);
      const unsigned bits = __ballot_sync(0xffffffffu, s);
      if (lane == 0) rows[(size_t)i * words + w] = bits;
    }
  }
  __syncthreads();

  if (warp != 0) return;
  unsigned removed = 0;  // lane l: word l of the mask (words <= 32)
  for (int i = 0; i < K; ++i) {
    const unsigned word = __shfl_sync(0xffffffffu, removed, i >> 5);
    const bool kept = svalid[i] && !((word >> (i & 31)) & 1u);
    if (kept && lane >= (i >> 5) && lane < words)
      removed |= rows[(size_t)i * words + lane];
    if (lane == (i & 31)) keep[img + i] = kept;
  }
}

}  // namespace

extern "C" {

// boxes [B, K, 4] float32 (x1, y1, x2, y2), cls [B, K] int32, valid and
// keep [B, K] bool (one byte each), all contiguous; thresh_bits: the
// threshold's float32 bits.
int yolo_nms_greedy(const void* boxes, const void* cls, const void* valid,
                    void* keep, int B, int K, int thresh_bits,
                    void* stream) {
  if (B < 1 || K < 1 || K > NMS_MAX_K || B > 2147483647 / K)
    return (int)cudaErrorInvalidValue;
  const size_t smem = nms_smem(K);
  cudaError_t err = cudaFuncSetAttribute(
      nms_greedy_keep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)nms_smem(NMS_MAX_K));
  if (err != cudaSuccess) return (int)err;
  float thresh;
  std::memcpy(&thresh, &thresh_bits, sizeof thresh);
  nms_greedy_keep<<<B, NMS_THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(cls),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), K,
      thresh);
  return (int)cudaGetLastError();
}

}  // extern "C"
