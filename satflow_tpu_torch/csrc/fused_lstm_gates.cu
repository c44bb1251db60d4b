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
// against 14 bytes (bf16: 4 gates + c in, h' + c' out), far below the ~295
// FLOP/byte at which an H100 stops being bound by its memory. At MetNet's
// shape (49,152 rows x C=64, bf16) one call moves ~44 MB: ~13 us at 3.35 TB/s;
// at the concat forward's (524,288 x 64) ~470 MB: ~140 us.
//
// Two kernels, chosen per call by the wrapper's stated rule
// (ops/fused_lstm.py::vector_path):
//
// - fused_lstm_gates_vec_kernel, when C is a multiple of 8 (bf16) or 4 (f32),
//   every base pointer is 16-byte aligned and c has fewer than 2^31
//   elements. A thread owns 16 bytes of consecutive channels of one row: one
//   16-byte load from each of the four gate blocks and from c, one 16-byte
//   store to each of h' and c'. Its (row, column) is divided out once, with
//   32-bit arithmetic.
//   The gates are read once, so they are loaded with the streaming hint
//   (ld.global.cs) and do not displace h' and c', which are stored normally:
//   the next step reads them, and MetNet's 12.6 MB of them fit the 50 MB L2.
//   sigmoid is __expf with a fast divide; tanh is tanhf in the f32 instance
//   (TOL_K34_F32 holds it to 1e-5) and the hardware's tanh.approx.f32
//   (relative error ~2^-11, below the bf16 output's step of 2^-8) in the bf16
//   one. The grid is one thread per 16-byte vector, no loop: a sweep on the
//   card of grids capped at 1-16 blocks of 256 threads per SM, each thread
//   striding, found none faster than this (PERF.md, the K3 findings).
// - fused_lstm_gates_kernel, for everything else (odd widths, offset views):
//   the first simple port, one thread per (row, channel) element in a
//   grid-stride loop, neighbouring threads on neighbouring channels, full
//   precision expf / tanhf.
//
// The host side is kept short because at MetNet's shape a launch is as long
// as the kernel: the entry points set the device only when it is not the
// current one.

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

// --- the vector kernel ------------------------------------------------------

__device__ __forceinline__ float fast_sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

__device__ __forceinline__ float tanh_approx(float v) {
  float out;
  asm("tanh.approx.f32 %0, %1;" : "=f"(out) : "f"(v));
  return out;
}

// 16 bytes of T, unpacked to and packed from f32
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[kN]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float tanh(float v) { return tanhf(v); }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ float2 pair(unsigned int w) {
    __nv_bfloat162 b;
    *reinterpret_cast<unsigned int*>(&b) = w;
    return __bfloat1622float2(b);
  }
  static __device__ __forceinline__ unsigned int word(float lo, float hi) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned int*>(&b);
  }
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[kN]) {
    const float2 a = pair(u.x), b = pair(u.y), c = pair(u.z), d = pair(u.w);
    f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y, f[4] = c.x, f[5] = c.y, f[6] = d.x,
    f[7] = d.y;
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[kN]) {
    return make_uint4(word(f[0], f[1]), word(f[2], f[3]), word(f[4], f[5]), word(f[6], f[7]));
  }
  static __device__ __forceinline__ float tanh(float v) { return tanh_approx(v); }
};

// gates (rows, 4 * cv) and c, h', c' (rows, cv), in 16-byte vectors; one
// vector of c a thread
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_lstm_gates_vec_kernel(const uint4* __restrict__ gates, const uint4* __restrict__ c,
                            uint4* __restrict__ h_out, uint4* __restrict__ c_out,
                            unsigned int total, unsigned int cv) {
  using V = Vec16<T>;
  const unsigned int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= total) return;
  const unsigned int row = v / cv;
  const unsigned int col = v - row * cv;
  const uint4* g = gates + (size_t(row) * 4 * cv + col);
  const uint4 ui = __ldcs(g), uf = __ldcs(g + cv), uo = __ldcs(g + 2 * cv),
              ug = __ldcs(g + 3 * cv);
  const uint4 uc = __ldg(c + v);
  float fi[V::kN], ff[V::kN], fo[V::kN], fg[V::kN], fc[V::kN], fh[V::kN];
  V::unpack(ui, fi);
  V::unpack(uf, ff);
  V::unpack(uo, fo);
  V::unpack(ug, fg);
  V::unpack(uc, fc);
#pragma unroll
  for (int k = 0; k < V::kN; ++k) {
    fc[k] = fast_sigmoid(ff[k]) * fc[k] + fast_sigmoid(fi[k]) * V::tanh(fg[k]);
    fh[k] = fast_sigmoid(fo[k]) * V::tanh(fc[k]);
  }
  c_out[v] = V::pack(fc);
  h_out[v] = V::pack(fh);
}

// --- the host side ----------------------------------------------------------

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

template <typename T>
int launch(const void* gates, const void* c, void* h_out, void* c_out, int64_t rows,
           int ch, int device, void* stream) {
  if (rows < 1 || ch < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return int(err);
  const int64_t total = rows * ch;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = int(want < kMaxBlocks ? want : kMaxBlocks);
  fused_lstm_gates_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c), static_cast<T*>(h_out),
      static_cast<T*>(c_out), rows, ch);
  return int(cudaGetLastError());
}

template <typename T>
int launch_vec(const void* gates, const void* c, void* h_out, void* c_out, int64_t rows,
               int ch, int device, void* stream) {
  constexpr int kN = Vec16<T>::kN;
  if (rows < 1 || ch < 1 || ch % kN != 0 || rows * ch >= (int64_t(1) << 31)) {
    return int(cudaErrorInvalidValue);
  }
  for (const void* p : {gates, c, static_cast<const void*>(h_out),
                        static_cast<const void*>(c_out)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return int(cudaErrorMisalignedAddress);
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return int(err);
  const unsigned int cv = unsigned(ch / kN);
  const unsigned int total = unsigned(rows) * cv;
  const unsigned int blocks = (total + kThreads - 1) / kThreads;
  fused_lstm_gates_vec_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(gates), static_cast<const uint4*>(c),
      static_cast<uint4*>(h_out), static_cast<uint4*>(c_out), total, cv);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); they launch on `stream` and do not
// synchronise. The _vec entry points refuse what the vector kernel does not
// take (cudaErrorInvalidValue, cudaErrorMisalignedAddress).
extern "C" {

int satflow_fused_lstm_gates_f32(const void* gates, const void* c, void* h_out, void* c_out,
                                 int64_t rows, int ch, int device, void* stream) {
  return launch<float>(gates, c, h_out, c_out, rows, ch, device, stream);
}

int satflow_fused_lstm_gates_bf16(const void* gates, const void* c, void* h_out, void* c_out,
                                  int64_t rows, int ch, int device, void* stream) {
  return launch<__nv_bfloat16>(gates, c, h_out, c_out, rows, ch, device, stream);
}

int satflow_fused_lstm_gates_vec_f32(const void* gates, const void* c, void* h_out,
                                     void* c_out, int64_t rows, int ch, int device,
                                     void* stream) {
  return launch_vec<float>(gates, c, h_out, c_out, rows, ch, device, stream);
}

int satflow_fused_lstm_gates_vec_bf16(const void* gates, const void* c, void* h_out,
                                      void* c_out, int64_t rows, int ch, int device,
                                      void* stream) {
  return launch_vec<__nv_bfloat16>(gates, c, h_out, c_out, rows, ch, device, stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
