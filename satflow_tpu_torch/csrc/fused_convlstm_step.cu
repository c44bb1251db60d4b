// Fused ConvLSTM step for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel satflow_tpu/ops/pallas/fused_convlstm_step.py::
// _step_pallas_padded (and its unpadded sibling _step_pallas). One launch
// computes, on unpadded NHWC tensors,
//
//   gates = conv3x3_SAME(x, Wx) + conv3x3_SAME(h, Wh) + b     (f32 accumulate)
//   i, f, o, g = split(gates, 4)                               (gate order i, f, o, g)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
//
// with f32 gate math, and h', c' stored in the input type (float or bf16).
// The weights keep the JAX HWIO layout: Wx (3, 3, Cx, 4Ch), Wh (3, 3, Ch, 4Ch),
// b (4Ch). Ch is 8, 16, 32, 64, 128 or 256 (above 128 in groups of 128
// hidden channels, one group a block, every group's block staging the whole
// window); Cx is any width from 1 to 256.
//
// What bounds it on this card. At the serving shape (B=8, 256x256, Cx=Ch=64)
// one call is 2 * B*H*W * 4Ch * 9(Cx+Ch) = 0.31 TFLOP against ~0.34 GB of
// x, h, c in and h', c' out: ~900 FLOP/byte, three times the ~295 FLOP/byte
// at which an H100 stops being bound by its memory. The call is bound by
// operations: 0.31 ms at the bf16 tensor cores' 989 TFLOP/s.
//
// Design. bfloat16 contracts on the tensor cores: an implicit GEMM per block
// of 8 x 16 pixels, mma.sync m16n8k16 on a window staged once as bf16 and
// weight slabs in a cp.async ring (convlstm_mma.cuh). float32 keeps its f32
// FMAs on the CUDA cores (convlstm_tile.cuh; 67 TFLOP/s peak), so that it
// agrees with an f32 reference to f32 rounding. Both leave all four gates of a
// (pixel, channel pair) in one thread (convlstm_gates.cuh, shared with the
// backward, K2), and the LSTM epilogue here turns them into h' and c' with one
// 4- or 8-byte load of c and two such stores, no exchange between threads. Its
// sigmoids and tanhs are expf and tanhf in both types, as in the reference's
// f32 gate math; with one block per SM nothing overlaps them.
//
// What this design leaves on the table: mma.sync feeds the tensor cores from
// registers, and the ldmatrix loads that fill them take shared memory's whole
// bandwidth at about half of the tensor cores' peak; wgmma reads its operands
// from shared memory and lifts that. Every block copies all the weights from
// L2 (0.6 MB at Cx=Ch=64); the window is staged before the first product and
// not under the previous tile's, and the exact epilogue (expf, tanhf and a
// division: ~150 instructions an element) runs after the last; and h', c' leave
// as 4-byte stores, 16 bytes of each 32-byte sector per warp store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "convlstm_gates.cuh"

namespace {

using namespace convlstm_gates;

template <typename T, int CH>
__global__ void __launch_bounds__(kThreads, 1)
fused_convlstm_step_kernel(const T* __restrict__ x, const T* __restrict__ h,
                           const T* __restrict__ c, const T* __restrict__ wx,
                           const T* __restrict__ wh, const T* __restrict__ bias,
                           T* __restrict__ h_out, T* __restrict__ c_out,
                           int height, int width, int cx) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows
  const Tile tile = tile_of_block<CH>();
  const ImageRows<T> src{x, h, tile.b, height, width, cx, CH};
  for_each_gate_pair<T, CH>(
      smem4, tile, src, wx, wh, bias, height, width, cx,
      [&](size_t pixel, int channel, float2 gi, float2 gf, float2 go, float2 gg) {
        lstm_pair(c, h_out, c_out, pixel * CH + channel, gi, gf, go, gg);
      });
}

template <typename T, int CH>
struct Step {
  static int run(const void* x, const void* h, const void* c, const void* wx,
                 const void* wh, const void* b, void* h_out, void* c_out, int batch,
                 int height, int width, int cx, int device, void* stream) {
    if (!geometry_ok<CH>(batch, height, width, cx)) return int(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const int smem = smem_bytes<T, CH>(cx);
    err = cudaFuncSetAttribute(fused_convlstm_step_kernel<T, CH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    fused_convlstm_step_kernel<T, CH><<<tile_grid<CH>(batch, height, width), kThreads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const T*>(c),
        static_cast<const T*>(wx), static_cast<const T*>(wh), static_cast<const T*>(b),
        static_cast<T*>(h_out), static_cast<T*>(c_out), height, width, cx);
    return int(cudaGetLastError());
  }
};

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* wx,
           const void* wh, const void* b, void* h_out, void* c_out, int batch,
           int height, int width, int cx, int ch, int device, void* stream) {
  for (const void* p : {h, c, wx, wh, static_cast<const void*>(h_out),
                        static_cast<const void*>(c_out)}) {
    if (!aligned<T>(p)) return int(cudaErrorMisalignedAddress);
  }
  return launch_for_width<Step, T>(ch, x, h, c, wx, wh, b, h_out, c_out, batch, height,
                                   width, cx, device, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); they launch on `stream` and do not
// synchronise.
extern "C" {

int satflow_fused_convlstm_step_f32(const void* x, const void* h, const void* c,
                                    const void* wx, const void* wh, const void* b,
                                    void* h_out, void* c_out, int batch, int height,
                                    int width, int cx, int ch, int device,
                                    void* stream) {
  return launch<float>(x, h, c, wx, wh, b, h_out, c_out, batch, height, width, cx,
                       ch, device, stream);
}

int satflow_fused_convlstm_step_bf16(const void* x, const void* h, const void* c,
                                     const void* wx, const void* wh, const void* b,
                                     void* h_out, void* c_out, int batch, int height,
                                     int width, int cx, int ch, int device,
                                     void* stream) {
  return launch<__nv_bfloat16>(x, h, c, wx, wh, b, h_out, c_out, batch, height,
                               width, cx, ch, device, stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
