// LSTM gate tail for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel satflow_tpu/ops/pallas/fused_lstm.py::_fused_pallas
// (kernel body _fused_kernel). From the pre-activations of one ConvLSTM step
// and the cell state it computes, per (row, channel),
//
//   i, f, o, g = gates[row, 0:C], gates[row, C:2C], gates[row, 2C:3C], gates[row, 3C:4C]
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
//
// with f32 math, storing h' and c' in the input type (float or bf16). gates is
// (rows, 4C) and c, h', c' are (rows, C), all contiguous; any row count and
// any C >= 1.
//
// What bounds it on this card: ~10 flops and 5 transcendentals per element
// against 12 bytes (bf16: 4 gates + c in, h' + c' out), far below the ~295
// FLOP/byte at which an H100 stops being bound by its memory. At MetNet's
// shape (49,152 rows x C=64, bf16) one call moves ~44 MB: ~13 us at 3.35 TB/s.
//
// Design (simple and right first): one thread per (row, channel) element in a
// grid-stride loop. Neighbouring threads take neighbouring channels, so every
// load and store of a warp is one contiguous run (the four gate reads of a
// warp are four such runs, C apart). What it leaves on the table: 16-byte
// vector loads (bf16 pairs or quads), and fusing into the gate conv's
// epilogue, which would save the gates' round trip through device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks of 256 threads per SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_lstm_gates_kernel(const T* __restrict__ gates, const T* __restrict__ c,
                        T* __restrict__ h_out, T* __restrict__ c_out, int64_t rows,
                        int ch) {
  const int64_t total = rows * ch;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int64_t row = e / ch;
    const int64_t j = e - row * ch;
    const T* g = gates + row * (4 * int64_t(ch)) + j;
    const float i_pre = to_f32(g[0]);
    const float f_pre = to_f32(g[ch]);
    const float o_pre = to_f32(g[2 * ch]);
    const float g_pre = to_f32(g[3 * ch]);
    const float c_next = sigmoid(f_pre) * to_f32(c[e]) + sigmoid(i_pre) * tanhf(g_pre);
    c_out[e] = from_f32<T>(c_next);
    h_out[e] = from_f32<T>(sigmoid(o_pre) * tanhf(c_next));
  }
}

template <typename T>
int launch(const void* gates, const void* c, void* h_out, void* c_out, int64_t rows,
           int ch, int device, void* stream) {
  if (rows < 1 || ch < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int64_t total = rows * ch;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = int(want < kMaxBlocks ? want : kMaxBlocks);
  fused_lstm_gates_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c), static_cast<T*>(h_out),
      static_cast<T*>(c_out), rows, ch);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); they launch on `stream` and do not
// synchronise.
extern "C" {

int satflow_fused_lstm_gates_f32(const void* gates, const void* c, void* h_out, void* c_out,
                                 int64_t rows, int ch, int device, void* stream) {
  return launch<float>(gates, c, h_out, c_out, rows, ch, device, stream);
}

int satflow_fused_lstm_gates_bf16(const void* gates, const void* c, void* h_out, void* c_out,
                                  int64_t rows, int ch, int device, void* stream) {
  return launch<__nv_bfloat16>(gates, c, h_out, c_out, rows, ch, device, stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
