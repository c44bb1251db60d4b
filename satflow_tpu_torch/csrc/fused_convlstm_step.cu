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
// b (4Ch). Ch is fixed at 64 (the shipped model's hidden width); Cx is any
// multiple of 4 up to 256.
//
// What bounds it on this card. At the serving shape (B=8, 256x256, Cx=Ch=64)
// one call is 2 * B*H*W * 4Ch * 9(Cx+Ch) = 0.31 TFLOP against ~0.34 GB of
// x, h, c in and h', c' out: ~900 FLOP/byte, three times the ~295 FLOP/byte
// at which an H100 stops being bound by its memory. The call is compute-bound.
//
// Design (simple and right first): the 8x16-pixel tile of convlstm_tile.cuh
// (shared with the backward, K2) computes the gate pre-activations into
// registers; the LSTM epilogue here turns them into h' and c'.
//
// What this design leaves on the table: the contraction runs as f32 FMAs on
// the CUDA cores (67 TFLOP/s peak) instead of the tensor cores (989 TFLOP/s
// bf16, via mma.sync or wgmma); weights are re-read from L1/L2 by every block
// instead of being staged once per SM with TMA; one block per SM (register
// bound) leaves staging and compute unoverlapped; and the halo window re-reads
// 1.4x the tile's inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "convlstm_tile.cuh"

namespace {

using namespace convlstm_tile;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_convlstm_step_kernel(const T* __restrict__ x, const T* __restrict__ h,
                           const T* __restrict__ c, const T* __restrict__ wx,
                           const T* __restrict__ wh, const T* __restrict__ bias,
                           T* __restrict__ h_out, T* __restrict__ c_out,
                           int height, int width, int cx) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  float acc[kTileW][4][kLaneCh];
  gate_preactivations(acc, reinterpret_cast<float*>(smem4), x, h, wx, wh, bias, b, y0,
                      x0, height, width, cx);

  const int row = threadIdx.x / 32;
  const int co = (threadIdx.x % 32) * kLaneCh;
  const int gy = y0 + row;
  if (gy >= height) return;
#pragma unroll
  for (int p = 0; p < kTileW; ++p) {
    const int gx = x0 + p;
    if (gx < width) {
      const size_t o = ((size_t(b) * height + gy) * width + gx) * kCh + co;
#pragma unroll
      for (int j = 0; j < kLaneCh; ++j) {
        const float c_prev = to_f32(c[o + j]);
        const float c_next = sigmoid(acc[p][1][j]) * c_prev +
                             sigmoid(acc[p][0][j]) * tanhf(acc[p][3][j]);
        const float h_next = sigmoid(acc[p][2][j]) * tanhf(c_next);
        c_out[o + j] = from_f32<T>(c_next);
        h_out[o + j] = from_f32<T>(h_next);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* wx,
           const void* wh, const void* b, void* h_out, void* c_out, int batch,
           int height, int width, int cx, int ch, int device, void* stream) {
  if (!shape_ok(batch, height, width, cx, ch)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int smem = window_bytes(cx);
  err = cudaFuncSetAttribute(fused_convlstm_step_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  fused_convlstm_step_kernel<T><<<tile_grid(batch, height, width), kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const T*>(c),
      static_cast<const T*>(wx), static_cast<const T*>(wh), static_cast<const T*>(b),
      static_cast<T*>(h_out), static_cast<T*>(c_out), height, width, cx);
  return int(cudaGetLastError());
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
