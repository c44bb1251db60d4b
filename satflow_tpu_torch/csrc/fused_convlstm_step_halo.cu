// Halo-tensor variant of the fused ConvLSTM step for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++ (K1h).
//
// Replaces the TPU kernel satflow_tpu/ops/pallas/fused_convlstm_step.py::
// _step_pallas_halo (kernel body _make_kernel_halo). It computes the same step
// as fused_convlstm_step.cu (K1),
//
//   gates = conv3x3_SAME(x, Wx) + conv3x3_SAME(h, Wh) + b     (f32 accumulate)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
//
// but reads its rows differently. The image is cut into row blocks of
// kHaloBlockH = 8 rows (the JAX default block_h). The row above and the row
// below each block are gathered outside the kernel into a side tensor per
// input, x_halo (B, H/8, 2, W, Cx) and h_halo (B, H/8, 2, W, Ch), with the
// zeros of the image's top and bottom edge already in them. A block stages
// the rows of its tile's window that lie inside its 8-row block from x and h
// and the rows outside it from the side tensors (HaloRows in
// convlstm_source.cuh). No row index is tested: H must be a multiple of 8,
// and every row a block touches exists in the tensor it is read from. The W
// boundary is still masked while staging, as in K1 (the side tensors are not
// W-padded: the port keeps unpadded NHWC). At Ch >= 128 a tile is 4 rows, so
// two tiles share a row block: only the first reads the row above from the
// side tensor, only the second the row below.
//
// Weights keep the JAX HWIO layout, Wx (3, 3, Cx, 4Ch), Wh (3, 3, Ch, 4Ch),
// b (4Ch); Ch is 8, 16, 32, 64, 128 or 256 and Cx any width from 1 to 256, as
// K1 (the wrapper zero-pads another Ch to the next of them).
//
// What bounds it on this card: as K1, operations (0.31 TFLOP against ~0.34 GB
// of state at B=8, 256x256, Cx=Ch=64; the side tensors add 2/8 of x and h).
//
// Design: K1's, with another source for the window. The contraction, the
// weight ring and the epilogue are K1's (convlstm_gates.cuh): bfloat16 on the
// tensor cores (mma.sync, convlstm_mma.cuh), float32 as f32 FMAs on the CUDA
// cores (convlstm_tile.cuh). What it leaves on the table is K1's, and the two
// gathers of the side tensors, which run as library copies before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "convlstm_gates.cuh"

namespace {

using namespace convlstm_gates;

template <typename T, int CH>
__global__ void __launch_bounds__(kThreads, 1)
fused_convlstm_step_halo_kernel(const T* __restrict__ x, const T* __restrict__ x_halo,
                                const T* __restrict__ h, const T* __restrict__ h_halo,
                                const T* __restrict__ c, const T* __restrict__ wx,
                                const T* __restrict__ wh, const T* __restrict__ bias,
                                T* __restrict__ h_out, T* __restrict__ c_out, int height,
                                int width, int cx) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows
  const Tile tile = tile_of_block<CH>();
  const HaloRows<T> src{x,      h,     x_halo, h_halo, tile.b,
                        height, width, cx,     CH,     tile.y0 / kHaloBlockH * kHaloBlockH};
  for_each_gate_pair<T, CH>(
      smem4, tile, src, wx, wh, bias, height, width, cx,
      [&](size_t pixel, int channel, float2 gi, float2 gf, float2 go, float2 gg) {
        lstm_pair(c, h_out, c_out, pixel * CH + channel, gi, gf, go, gg);
      });
}

template <typename T, int CH>
struct HaloStep {
  static int run(const void* x, const void* x_halo, const void* h, const void* h_halo,
                 const void* c, const void* wx, const void* wh, const void* b, void* h_out,
                 void* c_out, int batch, int height, int width, int cx, int device,
                 void* stream) {
    if (!geometry_ok<CH>(batch, height, width, cx) || height % kHaloBlockH != 0) {
      return int(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const int smem = smem_bytes<T, CH>(cx);
    err = cudaFuncSetAttribute(fused_convlstm_step_halo_kernel<T, CH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    fused_convlstm_step_halo_kernel<T, CH><<<tile_grid<CH>(batch, height, width), kThreads,
                                             smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(x_halo), static_cast<const T*>(h),
        static_cast<const T*>(h_halo), static_cast<const T*>(c), static_cast<const T*>(wx),
        static_cast<const T*>(wh), static_cast<const T*>(b), static_cast<T*>(h_out),
        static_cast<T*>(c_out), height, width, cx);
    return int(cudaGetLastError());
  }
};

template <typename T>
int launch(const void* x, const void* x_halo, const void* h, const void* h_halo,
           const void* c, const void* wx, const void* wh, const void* b, void* h_out,
           void* c_out, int batch, int height, int width, int cx, int ch, int device,
           void* stream) {
  for (const void* p : {h, h_halo, c, wx, wh, static_cast<const void*>(h_out),
                        static_cast<const void*>(c_out)}) {
    if (!aligned<T>(p)) return int(cudaErrorMisalignedAddress);
  }
  return launch_for_width<HaloStep, T>(ch, x, x_halo, h, h_halo, c, wx, wh, b, h_out, c_out,
                                       batch, height, width, cx, device, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); they launch on `stream` and do not
// synchronise.
extern "C" {

int satflow_fused_convlstm_step_halo_f32(const void* x, const void* x_halo, const void* h,
                                         const void* h_halo, const void* c, const void* wx,
                                         const void* wh, const void* b, void* h_out,
                                         void* c_out, int batch, int height, int width,
                                         int cx, int ch, int device, void* stream) {
  return launch<float>(x, x_halo, h, h_halo, c, wx, wh, b, h_out, c_out, batch, height,
                       width, cx, ch, device, stream);
}

int satflow_fused_convlstm_step_halo_bf16(const void* x, const void* x_halo, const void* h,
                                          const void* h_halo, const void* c, const void* wx,
                                          const void* wh, const void* b, void* h_out,
                                          void* c_out, int batch, int height, int width,
                                          int cx, int ch, int device, void* stream) {
  return launch<__nv_bfloat16>(x, x_halo, h, h_halo, c, wx, wh, b, h_out, c_out, batch,
                               height, width, cx, ch, device, stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
