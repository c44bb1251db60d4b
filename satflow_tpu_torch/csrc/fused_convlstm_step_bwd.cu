// Backward of the fused ConvLSTM step (the gate chain) for NVIDIA Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel satflow_tpu/ops/pallas/fused_convlstm_step.py::
// _gate_bwd_pallas (kernel body _make_bwd_kernel). One launch recomputes the
// gate pre-activations of the step with the forward's contraction
//
//   gates = conv3x3_SAME(x, Wx) + conv3x3_SAME(h, Wh) + b     (f32 accumulate)
//
// and runs the gate-chain backward in f32 (_gate_bwd_math):
//
//   si, sf, so = sigmoid(i, f, o);  tg = tanh(g);  c' = sf*c + si*tg;  tc = tanh(c')
//   do  = dh' * tc * so(1-so)
//   dct = dc' + dh' * so * (1 - tc^2)
//   di  = dct * tg * si(1-si);  df = dct * c * sf(1-sf);  dg = dct * si * (1 - tg^2)
//   dc_prev = dct * sf
//
// writing dgates = [di | df | do | dg] (B, H, W, 4Ch) and dc_prev (B, H, W, Ch)
// in the input type (float or bf16). The linear grads (dx, dh, dWx, dWh, db)
// are not this kernel's: the wrapper takes them from library convs of dgates,
// as the JAX package leaves them to XLA.
//
// What bounds it on this card: the recompute is K1's contraction, 2 * B*H*W *
// 4Ch * 9(Cx+Ch) FLOP = 0.31 TFLOP at B=8, 256x256, Cx=Ch=64, against ~0.67 GB
// (bf16) of x, h, c, dh', dc' in and dgates, dc_prev out: ~460 FLOP/byte, above
// the ~295 FLOP/byte where an H100 stops being bound by its memory, so the
// call is compute-bound like K1.
//
// Design (simple and right first): K1's 8x16-pixel tile (convlstm_tile.cuh,
// one definition of the contraction for both) with a new epilogue. Each
// thread already holds all four gates of its 16 pixels x 2 channels in
// registers, so the chain needs no exchange between threads; it reads c, dh'
// and dc' and writes five values per (pixel, channel). What it leaves on the
// table is K1's: f32 FMAs on the CUDA cores instead of the tensor cores, and
// weights re-read from L1/L2 by every block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "convlstm_tile.cuh"

namespace {

using namespace convlstm_tile;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gate_bwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                const T* __restrict__ c, const T* __restrict__ wx,
                const T* __restrict__ wh, const T* __restrict__ bias,
                const T* __restrict__ dh_next, const T* __restrict__ dc_next,
                T* __restrict__ dgates, T* __restrict__ dc_prev, int height,
                int width, int cx) {
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
      const size_t pix = (size_t(b) * height + gy) * width + gx;
      const size_t o = pix * kCh + co;
      const size_t o4 = pix * (4 * kCh) + co;
#pragma unroll
      for (int j = 0; j < kLaneCh; ++j) {
        const float cv = to_f32(c[o + j]);
        const float dh = to_f32(dh_next[o + j]);
        const float dc = to_f32(dc_next[o + j]);
        const float si = sigmoid(acc[p][0][j]);
        const float sf = sigmoid(acc[p][1][j]);
        const float so = sigmoid(acc[p][2][j]);
        const float tg = tanhf(acc[p][3][j]);
        const float tc = tanhf(sf * cv + si * tg);
        const float dct = dc + dh * so * (1.f - tc * tc);
        dgates[o4 + 0 * kCh + j] = from_f32<T>(dct * tg * si * (1.f - si));
        dgates[o4 + 1 * kCh + j] = from_f32<T>(dct * cv * sf * (1.f - sf));
        dgates[o4 + 2 * kCh + j] = from_f32<T>(dh * tc * so * (1.f - so));
        dgates[o4 + 3 * kCh + j] = from_f32<T>(dct * si * (1.f - tg * tg));
        dc_prev[o + j] = from_f32<T>(dct * sf);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* wx,
           const void* wh, const void* b, const void* dh_next, const void* dc_next,
           void* dgates, void* dc_prev, int batch, int height, int width, int cx,
           int ch, int device, void* stream) {
  if (!shape_ok(batch, height, width, cx, ch)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int smem = window_bytes(cx);
  err = cudaFuncSetAttribute(gate_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  gate_bwd_kernel<T><<<tile_grid(batch, height, width), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const T*>(c),
      static_cast<const T*>(wx), static_cast<const T*>(wh), static_cast<const T*>(b),
      static_cast<const T*>(dh_next), static_cast<const T*>(dc_next),
      static_cast<T*>(dgates), static_cast<T*>(dc_prev), height, width, cx);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); they launch on `stream` and do not
// synchronise.
extern "C" {

int satflow_gate_bwd_f32(const void* x, const void* h, const void* c, const void* wx,
                         const void* wh, const void* b, const void* dh_next,
                         const void* dc_next, void* dgates, void* dc_prev, int batch,
                         int height, int width, int cx, int ch, int device,
                         void* stream) {
  return launch<float>(x, h, c, wx, wh, b, dh_next, dc_next, dgates, dc_prev, batch,
                       height, width, cx, ch, device, stream);
}

int satflow_gate_bwd_bf16(const void* x, const void* h, const void* c, const void* wx,
                          const void* wh, const void* b, const void* dh_next,
                          const void* dc_next, void* dgates, void* dc_prev, int batch,
                          int height, int width, int cx, int ch, int device,
                          void* stream) {
  return launch<__nv_bfloat16>(x, h, c, wx, wh, b, dh_next, dc_next, dgates, dc_prev,
                               batch, height, width, cx, ch, device, stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
