// The general int8 conv + fixed-point requant of yolo_tpu_torch, for Hopper
// (sm_90a): the conv kernel of int8_conv.cuh at k = 1 or 3, any stride and
// padding, over one input or a two-part channel concat, with the leaky
// slope as the 0.125 shift or a Q16 rational. Plain C interface, loaded
// with ctypes by yolo_tpu_torch/kernels/int8_conv.py (int8_conv_requant).
//
// Replaces no Pallas kernel: it is the card's counterpart of XLA's integer
// conv_general_dilated in yolo_tpu/quant/fixed_point.py::int_conv_requant,
// which has no library counterpart on the card (F.conv2d refuses int8 and
// int32 CUDA tensors). What bounds it, and what the design does about
// that: int8_conv.cuh. Tiles are 32 or 64 columns wide; 1x1 convs and
// two-part inputs take the 16-byte gather only (C_in % 16 == 0). The
// 3x3s of one input with C_in % 32 == 0 (the yolo_v3 head's nine at
// stride 1, darknet53's five at stride 2) and the stride-1 3x3s of two
// such parts (tiny_yolo_v3's conv_set_1, yolo_v2's convsets_2.0) go to
// the wgmma kernel of int8_conv3x3_wgmma.cu instead, the stride-1 3x3s
// with C_in <= 3
// (yolo_v3's entry conv) to that of int8_entry_conv.cu, and the stride-1,
// pad-0 1x1s of one or two parts (yolo_v3's fourteen) to that of
// int8_conv1x1_wgmma.cu: no conv of the served paths runs here.

#include "int8_conv.cuh"

namespace {

template <int BN, int KS>
void dispatch_general_a(const ConvArgs& a, bool vec16, cudaStream_t st) {
  if (a.nparts == 2)
    launch_conv<BN, false, A_VEC16, KS, true>(a, st);
  else if (KS == 1 || vec16)
    launch_conv<BN, false, A_VEC16, KS, false>(a, st);
  else
    launch_conv<BN, false, A_BYTE, KS, false>(a, st);
}

template <int KS>
void dispatch_general(const ConvArgs& a, bool vec16, cudaStream_t st) {
  if (a.Cout <= 32)
    dispatch_general_a<32, KS>(a, vec16, st);
  else
    dispatch_general_a<64, KS>(a, vec16, st);
}

}  // namespace

extern "C" {

// The general form of int_conv_requant: x0 [B, H, W, cin0] (and, with
// nparts == 2, x1 [B, H, W, cin1], the second part of a channel concat),
// w0/w1 HWIO [ks, ks, cin_p, Cout] per part, ks in {1, 3}, any stride and
// padding; acc_shift0/1 bring each part's accumulator to the retune scale.
// slope_num: the LeakyReLU slope * 65536 (8192: 0.125; 65536: none).
// out: int8 [B, Ho, Wo, Cout]. Two parts and 1x1 convs need every part's
// C_in % 16 == 0; inputs are then 16-byte aligned, w 4-byte aligned, out
// 16-byte aligned; B * Ho * Wo < 2^31. Returns cudaGetLastError() after
// the launch.
int yolo_int8_conv_requant(const void* x0, const void* w0, const void* x1,
                           const void* w1, const void* bias_rt, void* out,
                           int B, int H, int W, int cin0, int cin1, int Cout,
                           int ks, int stride, int pad, int nparts,
                           int acc_shift0, int acc_shift1, int out_shift,
                           int slope_num, int nearest, void* stream) {
  if ((ks != 1 && ks != 3) || stride < 1 || pad < 0 || nparts < 1 ||
      nparts > 2)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * pad - ks) / stride + 1;
  const int Wo = (W + 2 * pad - ks) / stride + 1;
  const bool vec16 =
      cin0 % 16 == 0 && (nparts == 1 || cin1 % 16 == 0);
  if ((nparts == 2 || ks == 1) && !vec16) return (int)cudaErrorInvalidValue;
  ConvArgs a{{static_cast<const int8_t*>(x0), static_cast<const int8_t*>(x1)},
             {static_cast<const int8_t*>(w0), static_cast<const int8_t*>(w1)},
             {cin0, cin1},
             {acc_shift0, acc_shift1},
             nparts,
             static_cast<const int*>(bias_rt),
             static_cast<int8_t*>(out),
             B, H, W, Ho, Wo, Cout, stride, pad,
             Requant{out_shift, slope_num, nearest}, nullptr, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ks == 1)
    dispatch_general<1>(a, vec16, st);
  else
    dispatch_general<3>(a, vec16, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
