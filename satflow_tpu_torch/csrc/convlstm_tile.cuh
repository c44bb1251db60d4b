// The gate contraction of a ConvLSTM step on one tile of pixels as f32 FMAs on
// the CUDA cores, and the pieces every ConvLSTM kernel here shares (type
// conversions, the LSTM update, the tile's geometry).
//
//   gates = conv3x3_SAME(x, Wx) + conv3x3_SAME(h, Wh) + b     (f32 accumulate)
//
// on unpadded NHWC tensors, weights in the JAX HWIO layout: Wx (3, 3, Cx, 4Ch),
// Wh (3, 3, Ch, 4Ch), b (4Ch), gate order i, f, o, g.
//
// Used by the float32 instantiations of the fused step (K1), its backward
// (K2), the halo-tensor step (K1h) and the channel-major step (K6a) through
// convlstm_gates.cuh, at every hidden width CH they are built for, and by the
// float32 study kernels of exp_tap9.cu (T1, T2, K1p). The bfloat16 K1, K2,
// K1h, K6a and study kernels contract on the tensor cores instead
// (convlstm_mma.cuh).
//
// Tile. A block of 8 warps owns kTileW = 16 columns of tile_rows<CH>() rows
// and block_ch<CH>() hidden channels: all CH up to 128; above 128 the hidden
// channels are cut into groups of 128 along the grid's z axis (z = image x
// groups), and every group's block stages the whole window. It stages the
// tile's window of [x | h] (a one-pixel halo) in shared memory as f32, x's
// channels padded with zeros to a multiple of 4, with the zeros of SAME
// padding written there, so the inner loop has no bounds checks. A warp
// computes one tile row for one block of up to 64 hidden channels; Lanes<CH>
// says how its 32 lanes share that row:
//
//   CH    lanes across channel pairs x pixel groups   pixels a thread owns
//   8       4 x 8                                      2
//   16      8 x 4                                      4
//   32     16 x 2                                      8
//   64     32 x 1                                     16
//   128    32 x 1, and the block owns 4 rows, not 8:  16
//          warps 0-3 take channels 0-63, warps 4-7 channels 64-127
//   256    as 128, for the block's group of 128 channels
//
// A thread holds the four gate pre-activations (i, f, o, g) of its pixels x 2
// adjacent channels in at most 128 f32 registers, so an epilogue over the LSTM
// gates needs no exchange between threads. Pixel values are shared-memory
// broadcasts (the lanes of a pixel group read one address); weights come
// through the read-only cache as coalesced pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace convlstm_tile {

constexpr int kTileH = 8;           // output rows per block at CH <= 64, one per warp
constexpr int kTileW = 16;          // output columns per block (per warp)
constexpr int kLaneCh = 2;          // adjacent hidden channels a thread owns
constexpr int kThreads = 256;       // 8 warps
constexpr int kHaloW = kTileW + 2;
constexpr int kMaxCx = 256;         // keeps the staged window within 227 KB
constexpr int kMaxBlockCh = 128;    // hidden channels a block owns at most

// Hidden channels a block owns: all of CH up to 128, else a group of 128.
template <int CH>
__host__ __device__ constexpr int block_ch() { return CH < kMaxBlockCh ? CH : kMaxBlockCh; }
// Groups of block_ch<CH>() channels: blocks along the grid's z axis per image.
template <int CH>
__host__ __device__ constexpr int channel_groups() { return CH / block_ch<CH>(); }

// Output rows a block owns: 8, or 4 above 64 channels a block, where 8 warps
// are 4 rows x 2 channel blocks of 64 and the staged window stays within
// shared memory.
template <int CH>
__host__ __device__ constexpr int tile_rows() {
  return block_ch<CH>() > 64 ? kTileH * 64 / block_ch<CH>() : kTileH;
}

// How the lanes of a warp share one tile row (see the table above).
template <int CH>
struct Lanes {
  static_assert(CH == 8 || CH == 16 || CH == 32 || CH == 64 || CH == 128 || CH == 256,
                "hidden widths the tile is written for");
  static constexpr int kBlock = block_ch<CH>();
  static constexpr int kPairs = kBlock < 64 ? kBlock / 2 : 32;  // lanes across channel pairs
  static constexpr int kGroups = 32 / kPairs;                   // lanes across pixel groups
  static constexpr int kPix = kTileW / kGroups;                 // pixels a thread owns
  __device__ static int row() { return (threadIdx.x / 32) % tile_rows<CH>(); }
  __device__ static int pixel0() { return (threadIdx.x % 32) / kPairs * kPix; }
  // the first of the thread's two hidden channels within the block's group
  __device__ static int channel() {
    return (threadIdx.x / 32) / tile_rows<CH>() * 64 + (threadIdx.x % 32) % kPairs * kLaneCh;
  }
};

// Where a block of the tile grid stands: image b, its group of hidden
// channels, and the tile's first row and column.
struct Tile {
  int b, group, y0, x0;
};
template <int CH>
__device__ __forceinline__ Tile tile_of_block() {
  return Tile{int(blockIdx.z) / channel_groups<CH>(), int(blockIdx.z) % channel_groups<CH>(),
              int(blockIdx.y) * tile_rows<CH>(), int(blockIdx.x) * kTileW};
}

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

// Two adjacent values (channels co and co+1) as f32; p is aligned to the pair.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  // bf16 is the high half of an f32: widen both halves of one 32-bit load
  const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// acc[p][g][j] += sum_{k < 4} s[p * stride + k] * w[k * 4CH + g * CH + j] for
// the thread's pixels p: four rows of the weights against four staged values
// a pixel. With kTail only the first `rows` of the four weight rows exist and
// are read; the staged values past them are zeros.
template <int CH, bool kTail, typename T>
__device__ __forceinline__ void accumulate_4(float (&acc)[Lanes<CH>::kPix][4][kLaneCh],
                                             const float* __restrict__ s, int stride,
                                             const T* __restrict__ w, int rows) {
  float wr[4][4][kLaneCh];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float2 v = !kTail || k < rows ? load_pair(w + k * (4 * CH) + g * CH)
                                          : make_float2(0.f, 0.f);
      wr[k][g][0] = v.x;
      wr[k][g][1] = v.y;
    }
  }
#pragma unroll
  for (int p = 0; p < Lanes<CH>::kPix; ++p) {
    const float4 v4 = *reinterpret_cast<const float4*>(s + p * stride);
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

// acc[p][g][j] += sum_{ci < n} s[p * stride + ci] * w[ci * 4CH + g * CH + j]
// for the thread's pixels p; s points at its first pixel, w at its channel.
// The staged values s[.. + ci] for n <= ci < round_up(n, 4) are zeros; the
// weight rows there do not exist and are not read: the loop over whole fours
// tests nothing, and the last one to three rows take the tail's form.
template <int CH, typename T>
__device__ __forceinline__ void accumulate(float (&acc)[Lanes<CH>::kPix][4][kLaneCh],
                                           const float* __restrict__ s, int stride,
                                           const T* __restrict__ w, int n) {
  const int whole = n & ~3;
#pragma unroll 1
  for (int ci = 0; ci < whole; ci += 4) {
    accumulate_4<CH, false>(acc, s + ci, stride, w + ci * (4 * CH), 4);
  }
  if (n & 3) accumulate_4<CH, true>(acc, s + whole, stride, w + whole * (4 * CH), n & 3);
}

// acc[p][g][j] = bias of gate g, hidden channel co + j, for every pixel p.
template <int CH, typename T>
__device__ __forceinline__ void init_with_bias(float (&acc)[Lanes<CH>::kPix][4][kLaneCh],
                                               const T* __restrict__ bias, int co) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int j = 0; j < kLaneCh; ++j) {
      const float bv = to_f32(bias[g * CH + co + j]);
#pragma unroll
      for (int p = 0; p < Lanes<CH>::kPix; ++p) acc[p][g][j] = bv;
    }
  }
}

// The contraction over a staged window: on return, acc[p][g][j] holds gate g
// of hidden channel group * block_ch<CH>() + Lanes<CH>::channel() + j at the
// tile's pixel (Lanes<CH>::row(), Lanes<CH>::pixel0() + p). `window` holds the
// tile's (tile_rows<CH>() + 2) x (kTileW + 2) pixels of [x | h] as f32, cxp +
// CH = cin values a pixel, cxp = cx rounded up to a multiple of 4 with zeros
// between, and must be complete (a __syncthreads() after the last write)
// before the call.
template <int CH, typename T>
__device__ __forceinline__ void contract_window(
    float (&acc)[Lanes<CH>::kPix][4][kLaneCh], const float* __restrict__ window,
    const T* __restrict__ wx, const T* __restrict__ wh, const T* __restrict__ bias,
    int cx, int cxp, int cin, int group) {
  const int row = Lanes<CH>::row();
  const int p0 = Lanes<CH>::pixel0();
  const int co = group * block_ch<CH>() + Lanes<CH>::channel();

  init_with_bias<CH>(acc, bias, co);

#pragma unroll 1
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll 1
    for (int kx = 0; kx < 3; ++kx) {
      const int tap = ky * 3 + kx;
      const float* s = window + ((row + ky) * kHaloW + kx + p0) * cin;
      accumulate<CH>(acc, s, cin, wx + size_t(tap) * cx * (4 * CH) + co, cx);
      accumulate<CH>(acc, s + cxp, cin, wh + size_t(tap) * CH * (4 * CH) + co, CH);
    }
  }
}

// The gate pre-activations of the block's tile: `src` stages the window of
// its image at (tile.y0, tile.x0) (see convlstm_source.cuh for where the rows
// come from) and it is contracted against the tile's group of gate columns
// (see contract_window for what acc holds). `window` is the block's dynamic
// shared memory, window_bytes<CH>(cx) long. Every thread of the block must
// call it.
template <int CH, typename Src, typename T>
__device__ __forceinline__ void gate_preactivations(
    float (&acc)[Lanes<CH>::kPix][4][kLaneCh], float* __restrict__ window, const Src& src,
    const T* __restrict__ wx, const T* __restrict__ wh, const T* __restrict__ bias,
    const Tile& tile, int cx) {
  const int cxp = (cx + 3) & ~3;
  const int cin = cxp + CH;  // per staged pixel: x channels, zeros, then h channels

  // The window of [x | h] as f32; pixels outside the image are the zeros of
  // SAME padding.
  src.stage_f32(window, cin, cxp, tile_rows<CH>() + 2, tile.y0, tile.x0);
  __shared__ int pitch;
  if (threadIdx.x == 0) pitch = cin;
  __syncthreads();

  // The contraction takes the pixel pitch from shared memory, not as the sum
  // above: where ptxas sees cin = cxp + CH it rebuilds every pixel's address
  // from that sum, two address instructions a pixel where one does (3 % of the
  // inner loop's issue slots).
  contract_window<CH>(acc, window, wx, wh, bias, cx, cxp, pitch, tile.group);
}

// The LSTM state update of one element, f32: gates i, f, o, g and c -> c', h'.
__device__ __forceinline__ void lstm_update(float gi, float gf, float go, float gg,
                                            float c_prev, float& c_next, float& h_next) {
  c_next = sigmoid(gf) * c_prev + sigmoid(gi) * tanhf(gg);
  h_next = sigmoid(go) * tanhf(c_next);
}

template <int CH>
inline int window_bytes(int cx) {
  return (tile_rows<CH>() + 2) * kHaloW * (((cx + 3) & ~3) + CH) * int(sizeof(float));
}

template <int CH>
inline dim3 tile_grid(int batch, int height, int width) {
  return dim3((width + kTileW - 1) / kTileW, (height + tile_rows<CH>() - 1) / tile_rows<CH>(),
              batch * channel_groups<CH>());
}

// Whether a grid of (batch, height, width) fits the launch: z = batch x
// channel groups, y = row tiles, each at most 65535.
template <int CH>
inline bool grid_ok(int batch, int height, int width) {
  return batch > 0 && height > 0 && width > 0 &&
         (long long)batch * channel_groups<CH>() <= 65535 &&
         (height + tile_rows<CH>() - 1) / tile_rows<CH>() <= 65535;
}

}  // namespace convlstm_tile
