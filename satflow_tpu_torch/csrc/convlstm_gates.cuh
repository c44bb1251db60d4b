// The gate pre-activations of a ConvLSTM step, one definition for the fused
// step (fused_convlstm_step.cu, K1), its backward (fused_convlstm_step_bwd.cu,
// K2), the halo-tensor step (fused_convlstm_step_halo.cu, K1h) and the
// channel-major step (cmajor_convlstm.cu, K6a), at every hidden width they are
// built for:
//
//   gates = conv3x3_SAME(x, Wx) + conv3x3_SAME(h, Wh) + b     (f32 accumulate)
//
// bfloat16 contracts on the tensor cores (convlstm_mma.cuh); float32 keeps f32
// FMAs on the CUDA cores (convlstm_tile.cuh). Either way a block owns
// tile_rows<CH>() x 16 pixels and block_ch<CH>() hidden channels (all CH up
// to 128, a group of 128 above), a thread ends up with all four gates of each
// (pixel, channel pair) it owns, and for_each_gate_pair hands them to the
// kernel's epilogue, which therefore needs no exchange between threads and is
// written once for both dtypes. Where the window's pixels come from is the
// kernel's source (convlstm_source.cuh).
//
// Hidden widths: 8, 16, 32, 64, 128, 256 (launch_for_width). Cx: 1 to 256.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "convlstm_mma.cuh"
#include "convlstm_source.cuh"
#include "convlstm_tile.cuh"

namespace convlstm_gates {

using namespace convlstm_tile;
using namespace convlstm_source;

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

// Calls f(pixel, channel, gi, gf, go, gg) for every pixel of the image and
// pair of adjacent hidden channels (channel, channel + 1) that this thread of
// the block at `tile` (tile_of_block<CH>()) owns: pixel is the NHWC pixel
// index (b * H + y) * W + x, channel counts over all CH, and each gate is a
// float2 of pre-activations over the two channels. `src` stages the window.
// `smem` is the block's dynamic shared memory, smem_bytes<T, CH>(cx) long.
// Every thread of the block must call it.
template <typename T, int CH, typename Src, typename F>
__device__ __forceinline__ void for_each_gate_pair(
    void* smem, const Tile& tile, const Src& src, const T* __restrict__ wx,
    const T* __restrict__ wh, const T* __restrict__ bias, int height, int width, int cx,
    F&& f) {
  const int c0 = tile.group * block_ch<CH>();
  auto emit = [&](int row, int col, int channel, float2 gi, float2 gf, float2 go, float2 gg) {
    const int gy = tile.y0 + row;
    const int gx = tile.x0 + col;
    if (gy < height && gx < width) {
      f((size_t(tile.b) * height + gy) * width + gx, c0 + channel, gi, gf, go, gg);
    }
  };
  if constexpr (kTensorCores<T>) {
    convlstm_mma::Acc<CH> acc;
    convlstm_mma::gate_preactivations<CH>(acc, static_cast<unsigned char*>(smem), src, wx, wh,
                                          bias, tile, cx);
    convlstm_mma::for_each_pair<CH>(acc, emit);
  } else {
    float acc[Lanes<CH>::kPix][4][kLaneCh];
    gate_preactivations<CH>(acc, static_cast<float*>(smem), src, wx, wh, bias, tile, cx);
    const int row = Lanes<CH>::row();
    const int p0 = Lanes<CH>::pixel0();
    const int co = Lanes<CH>::channel();
#pragma unroll
    for (int p = 0; p < Lanes<CH>::kPix; ++p) {
      emit(row, p0 + p, co, make_float2(acc[p][0][0], acc[p][0][1]),
           make_float2(acc[p][1][0], acc[p][1][1]), make_float2(acc[p][2][0], acc[p][2][1]),
           make_float2(acc[p][3][0], acc[p][3][1]));
    }
  }
}

template <typename T, int CH>
inline int smem_bytes(int cx) {
  if constexpr (kTensorCores<T>) {
    return convlstm_mma::smem_bytes<CH>(cx);
  } else {
    return window_bytes<CH>(cx);
  }
}

// The tensor-core path copies and reads 16 bytes at a time; the CUDA-core
// path reads and writes pairs of floats.
template <typename T>
inline bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (kTensorCores<T> ? 16 : 8) == 0;
}

// What the kernels take besides a hidden width of launch_for_width; the
// wrappers check the same before a launch.
template <int CH>
inline bool geometry_ok(int batch, int height, int width, int cx) {
  return cx > 0 && cx <= kMaxCx && grid_ok<CH>(batch, height, width);
}

// Launcher<T, CH>::run(args...) for the hidden width ch, or
// cudaErrorInvalidValue for a width the kernels are not built for: 8, 16,
// 32, 64, 128 and 256, up to kMaxCh (nothing wider is instantiated).
template <template <typename, int> class Launcher, typename T, int kMaxCh = 256,
          typename... Args>
int launch_for_width(int ch, Args... args) {
  switch (ch) {
    case 8: return Launcher<T, 8>::run(args...);
    case 16: return Launcher<T, 16>::run(args...);
    case 32: return Launcher<T, 32>::run(args...);
    case 64: return Launcher<T, 64>::run(args...);
    case 128: return Launcher<T, 128>::run(args...);
    case 256:
      if constexpr (kMaxCh >= 256) return Launcher<T, 256>::run(args...);
      [[fallthrough]];
    default: return int(cudaErrorInvalidValue);
  }
}

// The LSTM update of a (pixel, channel pair) in NHWC: reads c at o (o = pixel
// * CH + channel), writes c' and h' there.
template <typename T>
__device__ __forceinline__ void lstm_pair(const T* __restrict__ c, T* __restrict__ h_out,
                                          T* __restrict__ c_out, size_t o, float2 gi, float2 gf,
                                          float2 go, float2 gg) {
  const float2 c_prev = load_pair(c + o);
  float2 c_next, h_next;
  lstm_update(gi.x, gf.x, go.x, gg.x, c_prev.x, c_next.x, h_next.x);
  lstm_update(gi.y, gf.y, go.y, gg.y, c_prev.y, c_next.y, h_next.y);
  store_pair(c_out + o, c_next.x, c_next.y);
  store_pair(h_out + o, h_next.x, h_next.y);
}

}  // namespace convlstm_gates
