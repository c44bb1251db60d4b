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
// kTileH = 8 rows. The row above and the row below each block are gathered
// outside the kernel into a side tensor per input, x_halo (B, H/8, 2, W, Cx)
// and h_halo (B, H/8, 2, W, Ch), with the zeros of the image's top and bottom
// edge already in them. A thread block owns 16 columns of one row block; it
// stages its eight interior rows from x and h and its two halo rows from the
// side tensors. No row index is tested anywhere in the kernel: H must be a
// multiple of 8, and every row a block touches exists in the tensor it is
// read from. The W boundary is still masked while staging, as in K1 (the side
// tensors are not W-padded: the port keeps unpadded NHWC).
//
// Weights keep the JAX HWIO layout, Wx (3, 3, Cx, 4Ch), Wh (3, 3, Ch, 4Ch),
// b (4Ch); Ch is fixed at 64, Cx is a multiple of 4 up to 256. The contraction
// and the thread layout are those of convlstm_tile.cuh, shared with K1 and K2.
//
// What bounds it on this card: as K1, operations (0.31 TFLOP against ~0.34 GB
// of state at B=8, 256x256, Cx=Ch=64; the side tensors add 2/8 of x and h).
// The variant exists to measure what the row-boundary tests and the
// out-of-kernel gather cost on this card; the contraction is K1's f32 FMAs on
// the CUDA cores and leaves the same on the table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "convlstm_tile.cuh"

namespace {

using namespace convlstm_tile;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_convlstm_step_halo_kernel(const T* __restrict__ x, const T* __restrict__ x_halo,
                                const T* __restrict__ h, const T* __restrict__ h_halo,
                                const T* __restrict__ c, const T* __restrict__ wx,
                                const T* __restrict__ wh, const T* __restrict__ bias,
                                T* __restrict__ h_out, T* __restrict__ c_out, int height,
                                int width, int cx) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows
  float* window = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z;
  const int rb = blockIdx.y;  // row block: image rows rb * kTileH .. + kTileH - 1
  const int x0 = blockIdx.x * kTileW;
  const int cin = cx + kCh;  // per staged pixel: x channels, then h channels

  // Interior rows of the window (1 .. kTileH) come from x and h.
  const int n_interior = kTileH * kHaloW * cin;
  for (int i = threadIdx.x; i < n_interior; i += kThreads) {
    const int ci = i % cin;
    const int pix = i / cin;
    const int gx = x0 - 1 + pix % kHaloW;
    float v = 0.f;
    if (gx >= 0 && gx < width) {
      const size_t base = (size_t(b) * height + rb * kTileH + pix / kHaloW) * width + gx;
      v = ci < cx ? to_f32(x[base * cx + ci]) : to_f32(h[base * kCh + (ci - cx)]);
    }
    window[kHaloW * cin + i] = v;
  }
  // Window rows 0 and kTileH + 1 come from the side tensors' two rows.
  const int n_halo = 2 * kHaloW * cin;
  for (int i = threadIdx.x; i < n_halo; i += kThreads) {
    const int ci = i % cin;
    const int pix = i / cin;
    const int k = pix / kHaloW;  // 0: the row above the block, 1: the row below
    const int gx = x0 - 1 + pix % kHaloW;
    float v = 0.f;
    if (gx >= 0 && gx < width) {
      const size_t base = ((size_t(b) * gridDim.y + rb) * 2 + k) * width + gx;
      v = ci < cx ? to_f32(x_halo[base * cx + ci]) : to_f32(h_halo[base * kCh + (ci - cx)]);
    }
    window[(k * (kTileH + 1) * kHaloW + pix % kHaloW) * cin + ci] = v;
  }
  __syncthreads();

  float acc[kTileW][4][kLaneCh];
  contract_window(acc, window, wx, wh, bias, cx);

  const int row = threadIdx.x / 32;
  const int co = (threadIdx.x % 32) * kLaneCh;
  const int gy = rb * kTileH + row;
#pragma unroll
  for (int p = 0; p < kTileW; ++p) {
    const int gx = x0 + p;
    if (gx < width) {
      const size_t o = ((size_t(b) * height + gy) * width + gx) * kCh + co;
#pragma unroll
      for (int j = 0; j < kLaneCh; ++j) {
        float c_next, h_next;
        lstm_update(acc[p][0][j], acc[p][1][j], acc[p][2][j], acc[p][3][j], to_f32(c[o + j]),
                    c_next, h_next);
        c_out[o + j] = from_f32<T>(c_next);
        h_out[o + j] = from_f32<T>(h_next);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* x_halo, const void* h, const void* h_halo,
           const void* c, const void* wx, const void* wh, const void* b, void* h_out,
           void* c_out, int batch, int height, int width, int cx, int ch, int device,
           void* stream) {
  if (!shape_ok(batch, height, width, cx, ch) || height % kTileH != 0) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int smem = window_bytes(cx);
  err = cudaFuncSetAttribute(fused_convlstm_step_halo_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  fused_convlstm_step_halo_kernel<T><<<tile_grid(batch, height, width), kThreads, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(x_halo), static_cast<const T*>(h),
      static_cast<const T*>(h_halo), static_cast<const T*>(c), static_cast<const T*>(wx),
      static_cast<const T*>(wh), static_cast<const T*>(b), static_cast<T*>(h_out),
      static_cast<T*>(c_out), height, width, cx);
  return int(cudaGetLastError());
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
