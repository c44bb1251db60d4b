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
//
// Also here: the bf16 LSTM epilogue of the channel-major steps (K6a, T3),
// cmajor_lstm_bf16, which writes h' and c' through a per-warp buffer in
// shared memory. The int8 step (K5), T3 and the bf16 T1, T2, K1p call
// convlstm_mma.cuh themselves: their weights are K-major (K5, T3) or the
// study tool's w9 and w3 read by strides (T1, T2, K1p), not HWIO.

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
    convlstm_mma::gate_preactivations<CH, convlstm_mma::Bf16>(
        acc, static_cast<unsigned char*>(smem), src, convlstm_mma::HwioWeights<CH>{wx, wh}, bias,
        tile, cx);
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

// The LSTM epilogue of a channel-major bf16 step on the tensor cores (K6a,
// T3) on planes (B, CH, rows * width): the tile's rows count from the planes'
// first row, and rows < pad_rows or >= rows - pad_rows are written as zeros
// (T3's pad rows; K6a has none). h' and c' leave through a per-warp
// [channel][pixel] buffer in shared memory, over the spent window (the caller
// has synchronised the block after the contraction): the warp's kRows x 16
// pixels of c (then c') and of h', a channel row padded by 16 bytes so that
// the four channel pairs a fragment holds fall on different banks. A warp
// reads and writes each channel plane as runs of 16 neighbouring pixels, and
// a thread turns the four gates of its (pixel, channel pair) into h' and c'
// with no exchange between threads.
template <int CH>
struct CmajorEpilogue {
  static_assert(CH <= kMaxBlockCh, "one group of channels a block");
  using S = convlstm_mma::Shape<CH>;
  static constexpr int kPixels = S::kRows * kTileW;  // the warp's pixels
  static constexpr int kPitch = kPixels * 2 + 16;    // bytes a channel row
  static constexpr int kWarpBytes = 2 * S::kWarpCh * kPitch;
  static constexpr int kBytes = 8 * kWarpBytes;
};

template <int CH>
__device__ __forceinline__ void cmajor_lstm_bf16(const convlstm_mma::Acc<CH>& acc,
                                                 unsigned char* smem, const Tile& tile,
                                                 const __nv_bfloat16* __restrict__ c,
                                                 __nv_bfloat16* __restrict__ h_out,
                                                 __nv_bfloat16* __restrict__ c_out, int rows,
                                                 int width, int pad_rows) {
  using S = convlstm_mma::Shape<CH>;
  using E = CmajorEpilogue<CH>;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp / S::kWarpsN;
  const int wn = warp % S::kWarpsN;
  const int row0 = tile.y0 + wm * S::kRows;  // the warp's first row
  const int ch0 = wn * S::kWarpCh;           // and first hidden channel
  const size_t plane = size_t(rows) * width;
  unsigned char* cbuf = smem + warp * E::kWarpBytes;    // c, then c'
  unsigned char* hbuf = cbuf + S::kWarpCh * E::kPitch;  // h'
  // the warp's buffers and planes, by the element, neighbouring lanes on
  // neighbouring pixels of a channel: f(buffer element, plane offset, pad row)
  auto for_each_element = [&](auto&& f) {
    for (int i = lane; i < S::kWarpCh * E::kPixels; i += 32) {
      const int ch = i / E::kPixels;
      const int px = i % E::kPixels;
      const int gy = row0 + px / kTileW;
      const int gx = tile.x0 + px % kTileW;
      if (gy < rows && gx < width) {
        const size_t o = (size_t(tile.b) * CH + ch0 + ch) * plane + size_t(gy) * width + gx;
        f(ch * E::kPitch + px * 2, o, gy < pad_rows || gy >= rows - pad_rows);
      }
    }
  };
  for_each_element([&](int at, size_t o, bool pad) {
    if (!pad) *reinterpret_cast<__nv_bfloat16*>(cbuf + at) = c[o];
  });
  __syncwarp();
  convlstm_mma::for_each_pair<CH>(
      acc, [&](int row, int col, int channel, float2 gi, float2 gf, float2 go, float2 gg) {
        const int at = (channel - ch0) * E::kPitch + ((row - wm * S::kRows) * kTileW + col) * 2;
        auto* c0 = reinterpret_cast<__nv_bfloat16*>(cbuf + at);
        auto* c1 = reinterpret_cast<__nv_bfloat16*>(cbuf + at + E::kPitch);
        float c_next, h_next;
        lstm_update(gi.x, gf.x, go.x, gg.x, __bfloat162float(*c0), c_next, h_next);
        *c0 = __float2bfloat16(c_next);
        *reinterpret_cast<__nv_bfloat16*>(hbuf + at) = __float2bfloat16(h_next);
        lstm_update(gi.y, gf.y, go.y, gg.y, __bfloat162float(*c1), c_next, h_next);
        *c1 = __float2bfloat16(c_next);
        *reinterpret_cast<__nv_bfloat16*>(hbuf + at + E::kPitch) = __float2bfloat16(h_next);
      });
  __syncwarp();
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for_each_element([&](int at, size_t o, bool pad) {
    c_out[o] = pad ? zero : *reinterpret_cast<const __nv_bfloat16*>(cbuf + at);
    h_out[o] = pad ? zero : *reinterpret_cast<const __nv_bfloat16*>(hbuf + at);
  });
}

}  // namespace convlstm_gates
