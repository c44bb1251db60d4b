// The gate contraction of a ConvLSTM step on one 8x16-pixel tile, shared by
// the fused step (fused_convlstm_step.cu, K1), its backward
// (fused_convlstm_step_bwd.cu, K2), the halo-tensor variant of the step
// (fused_convlstm_step_halo.cu, K1h) and the two study kernels of
// exp_tap9.cu (T1, T2), so that all compute the gates with one definition.
//
//   gates = conv3x3_SAME(x, Wx) + conv3x3_SAME(h, Wh) + b     (f32 accumulate)
//
// on unpadded NHWC tensors, weights in the JAX HWIO layout: Wx (3, 3, Cx, 4Ch),
// Wh (3, 3, Ch, 4Ch), b (4Ch), gate order i, f, o, g. Ch is fixed at 64 (the
// shipped model's hidden width); Cx is any multiple of 4 up to 256.
//
// Tile. A block owns 8 rows x 16 columns of one image and all 64 hidden
// channels: 8 warps, warp w computes tile row w, lane l owns hidden channels
// 2l and 2l+1. The block stages the tile's 10 x 18 window of [x | h] (a
// one-pixel halo) in shared memory as f32, with the zeros of SAME padding
// written there, so the inner loop has no bounds checks. Each thread then
// holds the four gate pre-activations (i, f, o, g) of its 16 pixels x 2
// channels in 128 f32 registers, so an epilogue over the LSTM gates needs no
// exchange between threads. Pixel values are shared-memory broadcasts (every
// lane of a warp reads the same address); weights come through the read-only
// cache as coalesced pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace convlstm_tile {

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

// acc[p][g][j] = bias of gate g, hidden channel co + j, for every pixel p.
template <typename T>
__device__ __forceinline__ void init_with_bias(float (&acc)[kTileW][4][kLaneCh],
                                               const T* __restrict__ bias, int co) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int j = 0; j < kLaneCh; ++j) {
      const float bv = to_f32(bias[g * kCh + co + j]);
#pragma unroll
      for (int p = 0; p < kTileW; ++p) acc[p][g][j] = bv;
    }
  }
}

// The contraction over a staged window: on return, acc[p][g][j] holds gate g
// of hidden channel (threadIdx.x % 32) * 2 + j at the tile's pixel
// (threadIdx.x / 32, p). `window` holds the tile's (kTileH+2) x (kTileW+2)
// pixels of [x | h] as f32, cx + kCh values a pixel, and must be complete
// (a __syncthreads() after the last write) before the call.
template <typename T>
__device__ __forceinline__ void contract_window(
    float (&acc)[kTileW][4][kLaneCh], const float* __restrict__ window,
    const T* __restrict__ wx, const T* __restrict__ wh, const T* __restrict__ bias,
    int cx) {
  const int cin = cx + kCh;
  const int row = threadIdx.x / 32;
  const int co = (threadIdx.x % 32) * kLaneCh;

  init_with_bias(acc, bias, co);

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
}

// The gate pre-activations of the block's tile: on return, acc[p][g][j] holds
// gate g of hidden channel (threadIdx.x % 32) * 2 + j at pixel
// (y0 + threadIdx.x / 32, x0 + p) of image b. `window` is the block's dynamic
// shared memory, window_bytes(cx) long. Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ void gate_preactivations(
    float (&acc)[kTileW][4][kLaneCh], float* __restrict__ window,
    const T* __restrict__ x, const T* __restrict__ h, const T* __restrict__ wx,
    const T* __restrict__ wh, const T* __restrict__ bias, int b, int y0, int x0,
    int height, int width, int cx) {
  const int cin = cx + kCh;  // per staged pixel: x channels, then h channels

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

  contract_window(acc, window, wx, wh, bias, cx);
}

// The LSTM state update of one element, f32: gates i, f, o, g and c -> c', h'.
__device__ __forceinline__ void lstm_update(float gi, float gf, float go, float gg,
                                            float c_prev, float& c_next, float& h_next) {
  c_next = sigmoid(gf) * c_prev + sigmoid(gi) * tanhf(gg);
  h_next = sigmoid(go) * tanhf(c_next);
}

// What the tile takes; the wrappers check the same before a launch.
inline bool shape_ok(int batch, int height, int width, int cx, int ch) {
  return ch == kCh && cx > 0 && cx % 4 == 0 && cx <= kMaxCx && batch > 0 &&
         batch <= 65535 && height > 0 && width > 0;
}

inline int window_bytes(int cx) { return kHaloH * kHaloW * (cx + kCh) * int(sizeof(float)); }

inline dim3 tile_grid(int batch, int height, int width) {
  return dim3((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, batch);
}

}  // namespace convlstm_tile
