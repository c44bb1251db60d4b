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
// Design (simple and right first). A block owns a tile of 8 rows x 16 columns
// of one image and all 64 hidden channels: 8 warps, warp w computes tile row w,
// lane l owns hidden channels 2l and 2l+1. The block stages the tile's
// 10 x 18 window of [x | h] (a one-pixel halo) in shared memory as f32, with
// the zeros of SAME padding written there, so the inner loop has no bounds
// checks. Each thread then holds the four gate pre-activations (i, f, o, g)
// of its 16 pixels x 2 channels in 128 f32 registers, so the LSTM epilogue
// needs no exchange between threads. Pixel values are shared-memory
// broadcasts (every lane of a warp reads the same address); weights come
// through the read-only cache as coalesced pairs.
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
#include <cstdint>

namespace {

constexpr int kCh = 64;             // hidden channels
constexpr int kTileH = 8;           // output rows per block, one per warp
constexpr int kTileW = 16;          // output columns per block (per warp)
constexpr int kLaneCh = kCh / 32;   // hidden channels per lane
constexpr int kThreads = 32 * kTileH;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kMaxCx = 256;         // keeps the staged window within 227 KB
static_assert(kLaneCh == 2, "load_pair reads two adjacent channels per lane");

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

// Two adjacent weights (channels co and co+1 of one gate) as f32.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  // bf16 is the high half of an f32: widen both halves of one 32-bit load
  const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// acc[p][g][j] += sum_{ci < n} s[p * stride + ci] * w[ci * 4Ch + g * Ch + j]
// for the 16 pixels p of one tile row; w already points at the lane's channel.
template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[kTileW][4][kLaneCh],
                                           const float* __restrict__ s, int stride,
                                           const T* __restrict__ w, int n) {
#pragma unroll 1
  for (int ci = 0; ci < n; ci += 4) {
    float wr[4][4][kLaneCh];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 v = load_pair(w + (ci + k) * (4 * kCh) + g * kCh);
        wr[k][g][0] = v.x;
        wr[k][g][1] = v.y;
      }
    }
#pragma unroll
    for (int p = 0; p < kTileW; ++p) {
      const float4 v4 = *reinterpret_cast<const float4*>(s + p * stride + ci);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
#pragma unroll
          for (int j = 0; j < kLaneCh; ++j) {
            acc[p][g][j] = fmaf(v[k], wr[k][g][j], acc[p][g][j]);
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_convlstm_step_kernel(const T* __restrict__ x, const T* __restrict__ h,
                           const T* __restrict__ c, const T* __restrict__ wx,
                           const T* __restrict__ wh, const T* __restrict__ bias,
                           T* __restrict__ h_out, T* __restrict__ c_out,
                           int height, int width, int cx) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows
  float* window = reinterpret_cast<float*>(smem4);
  const int cin = cx + kCh;  // per staged pixel: x channels, then h channels
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;

  // Stage the (kTileH+2) x (kTileW+2) window of [x | h] as f32; pixels
  // outside the image are the zeros of SAME padding.
  const int n_stage = kHaloH * kHaloW * cin;
  for (int i = threadIdx.x; i < n_stage; i += kThreads) {
    const int ci = i % cin;
    const int pix = i / cin;
    const int gy = y0 - 1 + pix / kHaloW;
    const int gx = x0 - 1 + pix % kHaloW;
    float v = 0.f;
    if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
      const size_t base = (size_t(b) * height + gy) * width + gx;
      v = ci < cx ? to_f32(x[base * cx + ci]) : to_f32(h[base * kCh + (ci - cx)]);
    }
    window[i] = v;
  }
  __syncthreads();

  const int row = threadIdx.x / 32;
  const int co = (threadIdx.x % 32) * kLaneCh;

  float acc[kTileW][4][kLaneCh];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int j = 0; j < kLaneCh; ++j) {
      const float bv = to_f32(bias[g * kCh + co + j]);
#pragma unroll
      for (int p = 0; p < kTileW; ++p) acc[p][g][j] = bv;
    }
  }

#pragma unroll 1
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll 1
    for (int kx = 0; kx < 3; ++kx) {
      const int tap = ky * 3 + kx;
      const float* s = window + ((row + ky) * kHaloW + kx) * cin;
      accumulate(acc, s, cin, wx + size_t(tap) * cx * (4 * kCh) + co, cx);
      accumulate(acc, s + cx, cin, wh + size_t(tap) * kCh * (4 * kCh) + co, kCh);
    }
  }

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
  if (ch != kCh || cx <= 0 || cx % 4 != 0 || cx > kMaxCx || batch <= 0 ||
      batch > 65535 || height <= 0 || width <= 0) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int smem = kHaloH * kHaloW * (cx + kCh) * int(sizeof(float));
  err = cudaFuncSetAttribute(fused_convlstm_step_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, batch);
  fused_convlstm_step_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
