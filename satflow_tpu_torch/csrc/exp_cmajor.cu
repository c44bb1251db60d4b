// The channel-major prototype's ConvLSTM step for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++ (T3).
//
// Replaces the TPU kernel tools/exp_cmajor.py::cmajor_step (kernel body
// _make_kernel). One launch computes the ConvLSTM step
//
//   gates = conv3x3_SAME(x, Wx) + conv3x3_SAME(h, Wh) + b     (f32 accumulate)
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
//
// on the prototype's layouts, which differ from K6a's (cmajor_convlstm.cu) in
// both operands:
//
// - the carries x, h, c are (B, C, SP) with SP = (H + 2 * block_h) * W: the
//   image flattened channel-major with block_h zero pad rows above and below.
//   The kernel reads the pad rows in place of any bounds test on rows (the
//   row above image row 0 is pad row block_h - 1, and so on), and writes the
//   pad rows of h' and c' back as zeros, so that the outputs are valid carries
//   of the next step. Tiles that fall on pad rows do no contraction. Only the
//   W boundary is masked while staging;
// - the weights are w9 (9, 4C, Cx+Ch): per (dy, dx) tap, gate-major rows (i,
//   f, o, g, each C wide) with the contraction axis [x ; h] fastest; b is
//   (4C, 1).
//
// C is fixed at 64 for x and h alike (the prototype's Cx == Ch), block_h is a
// multiple of 4 and H a multiple of block_h.
//
// Design (simple and right first). A block owns a tile of 4 rows x 32 columns
// of the padded image and stages its 6 x 34 window, one plane per input
// channel, as f32 in shared memory (104 KB). 8 warps; lane l owns column l of
// the 4 rows, warp w hidden channels 8w..8w+7, so a thread holds the four
// gates of 4 pixels x 8 channels in 128 f32 registers and the epilogue needs
// no exchange. With the contraction axis fastest, a thread reads its weights
// four input channels at a time: per tap and group of four input channels it
// loads the 16 window values once, then for each of its 32 (gate, channel)
// rows one 16-byte (f32) or 8-byte (bf16) vector, the same address for the
// whole warp, and issues 16 FMAs.
//
// What bounds it on this card: operations, as K6a (0.31 TFLOP against ~0.40
// GB with the pad rows at B=8, 256x256, block_h 8). The contraction runs as
// f32 FMAs on the CUDA cores; the tensor cores, for which this weight layout
// was made on the TPU, stay unused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileH = 4;
constexpr int kTileW = 32;          // one column per lane
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kPlane = kHaloH * kHaloW;
constexpr int kC = 64;              // channels of x, h and c
constexpr int kK = 2 * kC;          // contraction depth per tap: [x ; h]
constexpr int kWarpCh = 8;          // hidden channels per warp
constexpr int kThreads = 32 * (kC / kWarpCh);
constexpr int kKv = 4;              // input channels per weight vector

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

// Four adjacent weights along the contraction axis as f32.
__device__ __forceinline__ void load4(float (&out)[kKv], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void load4(float (&out)[kKv], const __nv_bfloat16* p) {
  // bf16 is the high half of an f32: widen both halves of each 32-bit word
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  out[0] = __uint_as_float(u.x << 16);
  out[1] = __uint_as_float(u.x & 0xffff0000u);
  out[2] = __uint_as_float(u.y << 16);
  out[3] = __uint_as_float(u.y & 0xffff0000u);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
exp_cmajor_step_kernel(const T* __restrict__ x, const T* __restrict__ h,
                       const T* __restrict__ c, const T* __restrict__ w9,
                       const T* __restrict__ bias, T* __restrict__ h_out,
                       T* __restrict__ c_out, int height, int width, int block_h) {
  extern __shared__ float4 smem4[];
  float* window = reinterpret_cast<float*>(smem4);  // kK planes: x's, then h's
  const int b = blockIdx.z;
  const int py0 = blockIdx.y * kTileH;  // first padded row of the tile
  const int x0 = blockIdx.x * kTileW;
  const int lane = threadIdx.x % 32;
  const int ch0 = (threadIdx.x / 32) * kWarpCh;
  const int gx = x0 + lane;
  const size_t sp = size_t(height + 2 * block_h) * width;

  // A tile on pad rows: zeros out, no contraction. block_h is a multiple of
  // the tile height, so a tile is all pad or all image.
  if (py0 < block_h || py0 >= block_h + height) {
    if (gx < width) {
      const T zero = from_f32<T>(0.f);
#pragma unroll
      for (int r = 0; r < kTileH; ++r) {
#pragma unroll
        for (int j = 0; j < kWarpCh; ++j) {
          const size_t o = (size_t(b) * kC + ch0 + j) * sp + size_t(py0 + r) * width + gx;
          h_out[o] = zero;
          c_out[o] = zero;
        }
      }
    }
    return;
  }

  // Stage the 6 x 34 windows of the 2C planes. Window row r is padded row
  // py0 - 1 + r, which always exists (block_h >= 4 pad rows on either side);
  // columns outside the image are the zeros of SAME padding.
  for (int i = threadIdx.x; i < kK * kPlane; i += kThreads) {
    const int col = i % kHaloW;
    const int r = (i / kHaloW) % kHaloH;
    const int k = i / kPlane;
    const int sx = x0 - 1 + col;
    float v = 0.f;
    if (sx >= 0 && sx < width) {
      const T* src = k < kC ? x : h;
      v = to_f32(src[(size_t(b) * kC + (k % kC)) * sp + size_t(py0 - 1 + r) * width + sx]);
    }
    window[i] = v;
  }
  __syncthreads();

  float acc[kTileH][4][kWarpCh];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int j = 0; j < kWarpCh; ++j) {
      const float bv = to_f32(bias[g * kC + ch0 + j]);
#pragma unroll
      for (int r = 0; r < kTileH; ++r) acc[r][g][j] = bv;
    }
  }

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap % 3;
    const T* w_tap = w9 + size_t(tap) * (4 * kC) * kK + size_t(ch0) * kK;
    const float* s_tap = window + dy * kHaloW + dx + lane;
#pragma unroll 1
    for (int k0 = 0; k0 < kK; k0 += kKv) {
      float v[kKv][kTileH];
#pragma unroll
      for (int k = 0; k < kKv; ++k) {
#pragma unroll
        for (int r = 0; r < kTileH; ++r) v[k][r] = s_tap[(k0 + k) * kPlane + r * kHaloW];
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int j = 0; j < kWarpCh; ++j) {
          float wv[kKv];
          load4(wv, w_tap + (size_t(g) * kC + j) * kK + k0);
#pragma unroll
          for (int k = 0; k < kKv; ++k) {
#pragma unroll
            for (int r = 0; r < kTileH; ++r) acc[r][g][j] = fmaf(v[k][r], wv[k], acc[r][g][j]);
          }
        }
      }
    }
  }

  if (gx >= width) return;
#pragma unroll
  for (int r = 0; r < kTileH; ++r) {
#pragma unroll
    for (int j = 0; j < kWarpCh; ++j) {
      const size_t o = (size_t(b) * kC + ch0 + j) * sp + size_t(py0 + r) * width + gx;
      const float c_prev = to_f32(c[o]);
      const float c_next = sigmoid(acc[r][1][j]) * c_prev +
                           sigmoid(acc[r][0][j]) * tanhf(acc[r][3][j]);
      const float h_next = sigmoid(acc[r][2][j]) * tanhf(c_next);
      c_out[o] = from_f32<T>(c_next);
      h_out[o] = from_f32<T>(h_next);
    }
  }
}

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* w9, const void* b,
           void* h_out, void* c_out, int batch, int height, int width, int channels,
           int block_h, int device, void* stream) {
  const int tiles_y = (height + 2 * block_h) / kTileH;
  if (channels != kC || batch <= 0 || batch > 65535 || height <= 0 || width <= 0 ||
      block_h <= 0 || block_h % kTileH != 0 || height % block_h != 0 || tiles_y > 65535) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int smem = kK * kPlane * int(sizeof(float));
  err = cudaFuncSetAttribute(exp_cmajor_step_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((width + kTileW - 1) / kTileW, tiles_y, batch);
  exp_cmajor_step_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const T*>(c),
      static_cast<const T*>(w9), static_cast<const T*>(b), static_cast<T*>(h_out),
      static_cast<T*>(c_out), height, width, block_h);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); they launch on `stream` and do not
// synchronise.
extern "C" {

int satflow_exp_cmajor_step_f32(const void* x, const void* h, const void* c, const void* w9,
                                const void* b, void* h_out, void* c_out, int batch,
                                int height, int width, int channels, int block_h, int device,
                                void* stream) {
  return launch<float>(x, h, c, w9, b, h_out, c_out, batch, height, width, channels, block_h,
                       device, stream);
}

int satflow_exp_cmajor_step_bf16(const void* x, const void* h, const void* c, const void* w9,
                                 const void* b, void* h_out, void* c_out, int batch,
                                 int height, int width, int channels, int block_h,
                                 int device, void* stream) {
  return launch<__nv_bfloat16>(x, h, c, w9, b, h_out, c_out, batch, height, width, channels,
                               block_h, device, stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
