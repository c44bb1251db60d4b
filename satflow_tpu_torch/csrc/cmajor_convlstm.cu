// Channel-major ConvLSTM step and 3x3 conv head for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++. Two kernels, one source.
//
// Replaces the TPU kernels of satflow_tpu/ops/pallas/cmajor_convlstm.py:
// _cell_pallas (kernel body _make_cell_kernel), here K6a, and _conv_pallas
// (kernel body _make_conv_kernel), here K6b. Tensors are channel-major with
// the image flattened, (B, C, H*W); the TPU layout's block_h zero pad rows
// above and below the image are dropped, and the zeros of SAME padding are
// written into the staged window instead. The TPU's lane rolls and
// W-boundary masks become a bounds test on the pixel index while staging.
//
// K6a, the step:
//   gates = conv3x3_SAME(x, Wx) + conv3x3_SAME(h, Wh) + b     (f32 accumulate)
//   i, f, o, g = split(gates, 4)                               (gate order i, f, o, g)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
// with f32 gate math, h' and c' stored in the input type (float or bf16).
// The weights stay in the JAX HWIO layout, Wx (3, 3, Cx, 4Ch), Wh (3, 3, Ch,
// 4Ch), b (4Ch): the per-tap (9, 4Ch, Cx+Ch) transform of the TPU kernel
// exists to feed its matrix unit and has no use here. Ch is fixed at 64; Cx
// is any width from 1 to 128.
//
// K6b, the head:  out = conv3x3_SAME(x, W) + b, x (B, Cin, H*W), W (3, 3, Cin,
// Cout) HWIO, out (B, Cout, H*W); Cin <= 128, Cout <= 16.
//
// What bounds them on this card. K6a at the serving shape (B=8, 256x256,
// Cx=Ch=64) is the same 0.31 TFLOP against ~0.34 GB as the NHWC step (K1):
// ~900 FLOP/byte, bound by operations. K6b (64 -> 12 channels) is 7.2 GFLOP
// against ~80 MB: ~90 FLOP/byte, bound by the bytes it moves.
//
// Design (simple and right first). Both kernels give a block a tile of 4 rows
// x 32 columns and stage its 6 x 34 window, one plane per input channel, in
// shared memory as f32. In this layout neighbouring lanes own neighbouring
// pixels of one channel, so global loads and stores along W are coalesced as
// they stand, and a warp's shared-memory reads fall in 32 different banks.
//   K6a: 8 warps; lane l owns column l of all 4 rows, warp w owns hidden
//   channels 8w..8w+7, so a thread holds the four gates of 4 pixels x 8
//   channels in 128 f32 registers and the LSTM epilogue needs no exchange.
//   Per input channel and dx it reads 6 window values, which serve the three
//   dy taps; the weights of a tap are the same for the whole warp (one
//   address, served as a broadcast from the read-only cache).
//   K6b: 4 warps, one per tile row; a thread holds all Cout (<= 16) outputs
//   of one pixel; the weights sit in shared memory padded to 16 columns.
//
// What this design leaves on the table: the contraction of K6a runs as f32
// FMAs on the CUDA cores instead of the tensor cores; its weights are re-read
// from L2 by every block; the 6 x 34 window re-reads 1.6x the tile's inputs.
// K6b reads x once per block row of four and spends its time on shared-memory
// reads, not on the HBM traffic that bounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileH = 4;
constexpr int kTileW = 32;          // one column per lane
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kPlane = kHaloH * kHaloW;

// K6a
constexpr int kCh = 64;             // hidden channels
constexpr int kWarpCh = 8;          // hidden channels per warp
constexpr int kCellThreads = 32 * (kCh / kWarpCh);
constexpr int kMaxCx = 128;         // keeps the staged window within 227 KB
// K6b
constexpr int kConvThreads = 32 * kTileH;
constexpr int kMaxCin = 128;
constexpr int kMaxCout = 16;

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

// Eight adjacent weights (16-byte aligned for bf16, 32-byte for f32) as f32.
__device__ __forceinline__ void load8(float (&out)[kWarpCh], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(float (&out)[kWarpCh], const __nv_bfloat16* p) {
  // bf16 is the high half of an f32: widen both halves of each 32-bit word
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = __uint_as_float(w[k] << 16);
    out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Stage the 6 x 34 windows of `channels` planes of src (B, channels, H*W) of
// image b into dst, one plane after another; pixels outside the image are the
// zeros of SAME padding.
template <typename T, int kThreads>
__device__ __forceinline__ void stage_planes(float* __restrict__ dst,
                                             const T* __restrict__ src, int channels,
                                             int b, int y0, int x0, int height,
                                             int width) {
  const size_t hw = size_t(height) * width;
  const int n = channels * kPlane;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int col = i % kHaloW;
    const int r = (i / kHaloW) % kHaloH;
    const int ci = i / kPlane;
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + col;
    float v = 0.f;
    if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
      v = to_f32(src[(size_t(b) * channels + ci) * hw + size_t(gy) * width + gx]);
    }
    dst[i] = v;
  }
}

// acc[r][g][j] += sum over the n input channels staged at s (planes) and the
// nine taps of  s[ci][r + dy][lane + dx] * w[tap][ci][g * Ch + j]; w already
// points at the warp's first channel, tap_stride = n * 4Ch.
template <typename T>
__device__ __forceinline__ void cell_accumulate(float (&acc)[kTileH][4][kWarpCh],
                                                const float* __restrict__ s,
                                                const T* __restrict__ w, int n,
                                                int lane) {
  const size_t tap_stride = size_t(n) * (4 * kCh);
#pragma unroll 1
  for (int ci = 0; ci < n; ++ci) {
    const float* plane = s + ci * kPlane + lane;
    const T* wc = w + size_t(ci) * (4 * kCh);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float v[kHaloH];
#pragma unroll
      for (int r = 0; r < kHaloH; ++r) v[r] = plane[r * kHaloW + dx];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float wr[4][kWarpCh];
#pragma unroll
        for (int g = 0; g < 4; ++g) load8(wr[g], wc + (dy * 3 + dx) * tap_stride + g * kCh);
#pragma unroll
        for (int r = 0; r < kTileH; ++r) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
#pragma unroll
            for (int j = 0; j < kWarpCh; ++j) {
              acc[r][g][j] = fmaf(v[r + dy], wr[g][j], acc[r][g][j]);
            }
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCellThreads, 1)
cmajor_cell_kernel(const T* __restrict__ x, const T* __restrict__ h, const T* __restrict__ c,
                   const T* __restrict__ wx, const T* __restrict__ wh,
                   const T* __restrict__ bias, T* __restrict__ h_out, T* __restrict__ c_out,
                   int height, int width, int cx) {
  extern __shared__ float4 smem4[];
  float* window = reinterpret_cast<float*>(smem4);  // (cx + kCh) planes: x, then h
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  stage_planes<T, kCellThreads>(window, x, cx, b, y0, x0, height, width);
  stage_planes<T, kCellThreads>(window + cx * kPlane, h, kCh, b, y0, x0, height, width);
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int ch0 = (threadIdx.x / 32) * kWarpCh;

  float acc[kTileH][4][kWarpCh];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int j = 0; j < kWarpCh; ++j) {
      const float bv = to_f32(bias[g * kCh + ch0 + j]);
#pragma unroll
      for (int r = 0; r < kTileH; ++r) acc[r][g][j] = bv;
    }
  }
  cell_accumulate(acc, window, wx + ch0, cx, lane);
  cell_accumulate(acc, window + cx * kPlane, wh + ch0, kCh, lane);

  const int gx = x0 + lane;
  if (gx >= width) return;
  const size_t hw = size_t(height) * width;
#pragma unroll
  for (int r = 0; r < kTileH; ++r) {
    const int gy = y0 + r;
    if (gy < height) {
#pragma unroll
      for (int j = 0; j < kWarpCh; ++j) {
        const size_t o = (size_t(b) * kCh + ch0 + j) * hw + size_t(gy) * width + gx;
        const float c_prev = to_f32(c[o]);
        const float c_next = sigmoid(acc[r][1][j]) * c_prev +
                             sigmoid(acc[r][0][j]) * tanhf(acc[r][3][j]);
        const float h_next = sigmoid(acc[r][2][j]) * tanhf(c_next);
        c_out[o] = from_f32<T>(c_next);
        h_out[o] = from_f32<T>(h_next);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
cmajor_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ out, int height, int width,
                   int cin, int cout) {
  extern __shared__ float4 smem4[];
  float* window = reinterpret_cast<float*>(smem4);       // cin planes
  float* ws = window + ((cin * kPlane + 3) / 4) * 4;     // (9, cin, 16), 16-byte aligned
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  stage_planes<T, kConvThreads>(window, x, cin, b, y0, x0, height, width);
  for (int i = threadIdx.x; i < 9 * cin * kMaxCout; i += kConvThreads) {
    const int co = i % kMaxCout;
    ws[i] = co < cout ? to_f32(w[size_t(i / kMaxCout) * cout + co]) : 0.f;
  }
  __syncthreads();

  const int row = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[kMaxCout];
#pragma unroll
  for (int co = 0; co < kMaxCout; ++co) acc[co] = co < cout ? to_f32(bias[co]) : 0.f;

#pragma unroll 1
  for (int ci = 0; ci < cin; ++ci) {
    const float* plane = window + ci * kPlane + row * kHaloW + lane;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float v = plane[(tap / 3) * kHaloW + tap % 3];
      const float4* w4 = reinterpret_cast<const float4*>(ws + (tap * cin + ci) * kMaxCout);
#pragma unroll
      for (int q = 0; q < kMaxCout / 4; ++q) {
        const float4 wv = w4[q];
        acc[4 * q + 0] = fmaf(v, wv.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
      }
    }
  }

  const int gy = y0 + row;
  const int gx = x0 + lane;
  if (gy >= height || gx >= width) return;
  const size_t hw = size_t(height) * width;
#pragma unroll
  for (int co = 0; co < kMaxCout; ++co) {
    if (co < cout) {
      out[(size_t(b) * cout + co) * hw + size_t(gy) * width + gx] = from_f32<T>(acc[co]);
    }
  }
}

inline dim3 tile_grid(int batch, int height, int width) {
  return dim3((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, batch);
}

inline bool image_ok(int batch, int height, int width) {
  return batch > 0 && batch <= 65535 && height > 0 && width > 0 &&
         (height + kTileH - 1) / kTileH <= 65535;
}

template <typename T>
int launch_cell(const void* x, const void* h, const void* c, const void* wx, const void* wh,
                const void* b, void* h_out, void* c_out, int batch, int height, int width,
                int cx, int ch, int device, void* stream) {
  if (!image_ok(batch, height, width) || ch != kCh || cx <= 0 || cx > kMaxCx) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int smem = (cx + kCh) * kPlane * int(sizeof(float));
  err = cudaFuncSetAttribute(cmajor_cell_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  cmajor_cell_kernel<T><<<tile_grid(batch, height, width), kCellThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const T*>(c),
      static_cast<const T*>(wx), static_cast<const T*>(wh), static_cast<const T*>(b),
      static_cast<T*>(h_out), static_cast<T*>(c_out), height, width, cx);
  return int(cudaGetLastError());
}

template <typename T>
int launch_conv(const void* x, const void* w, const void* b, void* out, int batch,
                int height, int width, int cin, int cout, int device, void* stream) {
  if (!image_ok(batch, height, width) || cin <= 0 || cin > kMaxCin || cout <= 0 ||
      cout > kMaxCout) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int smem =
      (((cin * kPlane + 3) / 4) * 4 + 9 * cin * kMaxCout) * int(sizeof(float));
  err = cudaFuncSetAttribute(cmajor_conv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  cmajor_conv_kernel<T><<<tile_grid(batch, height, width), kConvThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(out), height, width, cin, cout);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); they launch on `stream` and do not
// synchronise.
extern "C" {

int satflow_cmajor_cell_f32(const void* x, const void* h, const void* c, const void* wx,
                            const void* wh, const void* b, void* h_out, void* c_out,
                            int batch, int height, int width, int cx, int ch, int device,
                            void* stream) {
  return launch_cell<float>(x, h, c, wx, wh, b, h_out, c_out, batch, height, width, cx, ch,
                            device, stream);
}

int satflow_cmajor_cell_bf16(const void* x, const void* h, const void* c, const void* wx,
                             const void* wh, const void* b, void* h_out, void* c_out,
                             int batch, int height, int width, int cx, int ch, int device,
                             void* stream) {
  return launch_cell<__nv_bfloat16>(x, h, c, wx, wh, b, h_out, c_out, batch, height, width,
                                    cx, ch, device, stream);
}

int satflow_cmajor_conv_f32(const void* x, const void* w, const void* b, void* out,
                            int batch, int height, int width, int cin, int cout, int device,
                            void* stream) {
  return launch_conv<float>(x, w, b, out, batch, height, width, cin, cout, device, stream);
}

int satflow_cmajor_conv_bf16(const void* x, const void* w, const void* b, void* out,
                             int batch, int height, int width, int cin, int cout,
                             int device, void* stream) {
  return launch_conv<__nv_bfloat16>(x, w, b, out, batch, height, width, cin, cout, device,
                                    stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
