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
//
// K6b is two kernels, by type. Both are persistent: a grid of as many blocks
// as fit the card, each staging the weights in shared memory once (Cout padded
// to 16 columns with zeros) and then walking its share of the tiles.
//   bfloat16, cmajor_conv_mma_kernel: the head as an implicit GEMM on the
//   tensor cores, mma.sync m16n8k16 with f32 sums (the helpers of
//   convlstm_mma.cuh): M = pixels, K = 9 taps x Cin (padded to a multiple of
//   16), N = 16 (two n8 tiles). In this layout pixels are contiguous and
//   channels are not, so an ldmatrix row of 8 neighbouring pixels would lose
//   its 16-byte alignment at the dx = +-1 taps. Of the two ways out (three
//   dx-shifted copies of the window, or a transposed window) this kernel takes
//   the transposed one: a thread reads 8 pixels x 8 channels as eight 16-byte
//   loads (neighbouring lanes on neighbouring pieces of one plane), transposes
//   them in registers with byte permutes and writes eight 16-byte rows of a
//   [pixel][channel] bf16 window whose pitch carries 16 bytes of padding; a
//   tap is then a row offset and every ldmatrix row is aligned, as in K1, at
//   one third of the shifted copies' shared memory. The two halo columns (and
//   the whole window where W % 8 != 0) are staged by the element. A block of 8
//   warps owns 8 rows x 32 columns, a warp one row: two m16 tiles that share
//   the weights' B fragments (one ldmatrix.trans a k16 step for both n8
//   tiles). The sums leave through a per-warp [co][pixel] buffer in shared
//   memory, so that a warp's stores to one co plane are 64 contiguous bytes.
//   float32, cmajor_conv_kernel: f32 FMAs on the CUDA cores (the float32
//   tolerance allows no bf16 products). A block of 4 warps owns 16 rows x 32
//   columns and stages the window 8 input channels at a time; lane l owns
//   column l of 4 rows, so per input channel and dx it reads 6 window values
//   for the three dy taps of its 4 pixels, and one read of a tap's 16 weights
//   serves 4 pixels.
//
// What this design leaves on the table: the contraction of K6a runs as f32
// FMAs on the CUDA cores instead of the tensor cores; its weights are re-read
// from L2 by every block; the 6 x 34 window re-reads 1.6x the tile's inputs.
// The bf16 K6b stages a tile's window with plain loads before its first
// product (two blocks on an SM overlap each other, nothing overlaps within a
// block), its halo columns cost a 32-byte sector per 2-byte element, and N =
// 16 leaves the tensor cores mostly idle: it is bound by staging, not by the
// 24 us its bytes need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "convlstm_mma.cuh"

namespace {

using convlstm_mma::ldmatrix_x4;
using convlstm_mma::ldmatrix_x4_trans;
using convlstm_mma::mma_bf16;
using convlstm_mma::round_up_16;
using convlstm_mma::smem_addr;

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
constexpr int kMaxCin = 128;
constexpr int kMaxCout = 16;
// bfloat16: 8 warps, a warp one row of 32 pixels
constexpr int kMmaTileH = 8;
constexpr int kMmaThreads = 32 * kMmaTileH;
constexpr int kMmaWindow = (kMmaTileH + 2) * kHaloW;  // pixels of a staged window
constexpr int kWeightPitch = 48;   // bytes a staged weight row (16 bf16 and padding: the
                                   // 8 rows of an ldmatrix fall in different banks)
constexpr int kOutPitch = 80;      // bytes a co row of a warp's output buffer (32 bf16 + padding)
// float32: 4 warps, a warp 4 rows of 32 pixels, the window staged 8 channels at a time
constexpr int kConvRows = 4;       // rows a thread owns
constexpr int kConvWarps = 4;
constexpr int kConvTileH = kConvRows * kConvWarps;
constexpr int kConvThreads = 32 * kConvWarps;
constexpr int kConvChunk = 8;
constexpr int kConvPlane = (kConvTileH + 2) * kHaloW;

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

// The tile a persistent block takes at step `tile` of its walk: image b, first
// row y0, first column x0.
struct Tile {
  int b, y0, x0;
};
__device__ __forceinline__ Tile tile_at(int tile, int tiles_x, int tiles_y, int tile_h) {
  const int tx = tile % tiles_x;
  const int ty = (tile / tiles_x) % tiles_y;
  return Tile{tile / (tiles_x * tiles_y), ty * tile_h, tx * kTileW};
}

__device__ __forceinline__ int mma_window_pitch(int cinp) { return cinp * 2 + 16; }

inline int mma_conv_smem(int cin) {
  const int cinp = round_up_16(cin);
  return 9 * cinp * kWeightPitch + kMmaWindow * (cinp * 2 + 16) +
         kMmaTileH * kMaxCout * kOutPitch;
}

__global__ void __launch_bounds__(kMmaThreads)
cmajor_conv_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                       int batch, int height, int width, int cin, int cout) {
  extern __shared__ float4 smem4[];
  const int cinp = round_up_16(cin);
  const int pitch = mma_window_pitch(cinp);
  unsigned char* ws = reinterpret_cast<unsigned char*>(smem4);  // (9 * cinp) rows of 16 co
  unsigned char* window = ws + 9 * cinp * kWeightPitch;         // [pixel][channel]
  unsigned char* outs = window + kMmaWindow * pitch;            // per warp [co][pixel]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t hw = size_t(height) * width;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // the weights, once: row tap * cinp + ci holds w[tap][ci][0:cout] and zeros
  for (int i = threadIdx.x; i < 9 * cinp * kMaxCout; i += kMmaThreads) {
    const int co = i % kMaxCout;
    const int row = i / kMaxCout;
    const int ci = row % cinp;
    const int tap = row / cinp;
    reinterpret_cast<__nv_bfloat16*>(ws + row * kWeightPitch)[co] =
        ci < cin && co < cout ? w[(size_t(tap) * cin + ci) * cout + co] : zero;
  }
  // this thread's bias: accumulator e of n8 tile nt is co = 8 nt + 2 (lane % 4) + (e & 1)
  float bv[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = nt * 8 + (lane % 4) * 2 + e;
      bv[nt][e] = co < cout ? __bfloat162float(bias[co]) : 0.f;
    }
  }

  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles_y = (height + kMmaTileH - 1) / kMmaTileH;
  const int n_tiles = tiles_x * tiles_y * batch;
  // whole 16-byte pieces of 8 pixels: every row starts aligned and holds no partial piece
  const bool vec = width % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int ncg = cinp / 8;  // groups of 8 channels

  // ldmatrix row addresses of this lane. A: matrices (pixels 0-7, k 0-7),
  // (pixels 8-15, k 0-7), (pixels 0-7, k 8-15), (pixels 8-15, k 8-15) of the
  // warp's row at tap (0, 0). B (transposed on load): (k 0-7, co 0-7), (k 8-15,
  // co 0-7), (k 0-7, co 8-15), (k 8-15, co 8-15).
  const uint32_t a_lane = smem_addr(window) +
                          (warp * kHaloW + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch +
                          (lane >> 4) * 16;
  const uint32_t b_lane = smem_addr(ws) + ((lane & 7) + ((lane >> 3) & 1) * 8) * kWeightPitch +
                          (lane >> 4) * 16;
  unsigned char* out_w = outs + warp * kMaxCout * kOutPitch;

#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const Tile t = tile_at(tile, tiles_x, tiles_y, kMmaTileH);
    const __nv_bfloat16* xb = x + size_t(t.b) * cin * hw;
    __syncthreads();  // the previous tile's window has been read by every warp

    // by the element: channel ci of window pixel (r, col); zeros outside the
    // image and past cin
    auto stage_elements = [&](int col_first, int col_step, int cols) {
      for (int i = threadIdx.x; i < (kMmaTileH + 2) * cols * cinp; i += kMmaThreads) {
        const int ci = i % cinp;
        const int pix = i / cinp;
        const int col = col_first + (pix % cols) * col_step;
        const int r = pix / cols;
        const int gy = t.y0 - 1 + r;
        const int gx = t.x0 - 1 + col;
        const bool in = ci < cin && gy >= 0 && gy < height && gx >= 0 && gx < width;
        reinterpret_cast<__nv_bfloat16*>(window + (r * kHaloW + col) * pitch)[ci] =
            in ? xb[size_t(ci) * hw + size_t(gy) * width + gx] : zero;
      }
    };
    if (vec) {
      // the 32 interior columns: 8 pixels x 8 channels a thread, transposed in registers
      for (int i = threadIdx.x; i < (kMmaTileH + 2) * 4 * ncg; i += kMmaThreads) {
        const int cg = i % ncg;
        const int pg = (i / ncg) % 4;
        const int r = i / (ncg * 4);
        const int gy = t.y0 - 1 + r;
        const int gx = t.x0 + pg * 8;
        const bool in = gy >= 0 && gy < height && gx < width;
        unsigned int v[8][4];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          uint4 u = make_uint4(0u, 0u, 0u, 0u);
          if (in && cg * 8 + c < cin) {
            u = __ldg(reinterpret_cast<const uint4*>(xb + size_t(cg * 8 + c) * hw +
                                                     size_t(gy) * width + gx));
          }
          v[c][0] = u.x; v[c][1] = u.y; v[c][2] = u.z; v[c][3] = u.w;
        }
        unsigned char* dst = window + (r * kHaloW + 1 + pg * 8) * pitch + cg * 16;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          // pixel p is the low (p even) or high half of word p / 2 of every channel
          const unsigned int sel = (p & 1) ? 0x7632u : 0x5410u;
          uint4 o;
          o.x = __byte_perm(v[0][p / 2], v[1][p / 2], sel);
          o.y = __byte_perm(v[2][p / 2], v[3][p / 2], sel);
          o.z = __byte_perm(v[4][p / 2], v[5][p / 2], sel);
          o.w = __byte_perm(v[6][p / 2], v[7][p / 2], sel);
          *reinterpret_cast<uint4*>(dst + p * pitch) = o;
        }
      }
      stage_elements(0, kHaloW - 1, 2);  // the two halo columns
    } else {
      stage_elements(0, 1, kHaloW);
    }
    __syncthreads();

    float acc[2][2][4];  // [m16 tile][n8 tile]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        acc[mt][nt][0] = acc[mt][nt][2] = bv[nt][0];
        acc[mt][nt][1] = acc[mt][nt][3] = bv[nt][1];
      }
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t a_tap = a_lane + ((tap / 3) * kHaloW + tap % 3) * pitch;
      const uint32_t b_tap = b_lane + tap * cinp * kWeightPitch;
#pragma unroll 2
      for (int kc = 0; kc < cinp / 16; ++kc) {
        uint32_t b[4], a0[4], a1[4];
        ldmatrix_x4_trans(b, b_tap + kc * 16 * kWeightPitch);
        ldmatrix_x4(a0, a_tap + kc * 32);
        ldmatrix_x4(a1, a_tap + 16 * pitch + kc * 32);
        mma_bf16(acc[0][0], a0, b[0], b[1]);
        mma_bf16(acc[0][1], a0, b[2], b[3]);
        mma_bf16(acc[1][0], a1, b[0], b[1]);
        mma_bf16(acc[1][1], a1, b[2], b[3]);
      }
    }

    // accumulator e of (mt, nt): pixel 16 mt + lane / 4 + 8 (e >> 1), co as above
    __syncwarp();  // the warp's previous tile has left its buffer
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = nt * 8 + (lane % 4) * 2 + (e & 1);
          const int px = mt * 16 + lane / 4 + 8 * (e >> 1);
          reinterpret_cast<__nv_bfloat16*>(out_w + co * kOutPitch)[px] =
              __float2bfloat16(acc[mt][nt][e]);
        }
      }
    }
    __syncwarp();
    const int gy = t.y0 + warp;
    if (gy < height) {
      __nv_bfloat16* ob = out + size_t(t.b) * cout * hw + size_t(gy) * width + t.x0;
      if (vec) {
#pragma unroll
        for (int it = 0; it < 2; ++it) {
          const int co = it * 8 + lane / 4;
          const int piece = lane % 4;
          if (co < cout && t.x0 + piece * 8 < width) {
            *reinterpret_cast<uint4*>(ob + size_t(co) * hw + piece * 8) =
                *reinterpret_cast<const uint4*>(out_w + co * kOutPitch + piece * 16);
          }
        }
      } else {
        for (int i = lane; i < kMaxCout * kTileW; i += 32) {
          const int co = i / kTileW;
          const int px = i % kTileW;
          if (co < cout && t.x0 + px < width) {
            ob[size_t(co) * hw + px] =
                reinterpret_cast<const __nv_bfloat16*>(out_w + co * kOutPitch)[px];
          }
        }
      }
    }
  }
}

inline int conv_smem(int cin) {
  return (9 * cin * kMaxCout + kConvChunk * kConvPlane) * int(sizeof(float));
}

__global__ void __launch_bounds__(kConvThreads)
cmajor_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int batch,
                   int height, int width, int cin, int cout) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // (9, cin, 16), 16-byte aligned rows
  float* window = ws + 9 * cin * kMaxCout;      // kConvChunk planes of 18 x 34
  for (int i = threadIdx.x; i < 9 * cin * kMaxCout; i += kConvThreads) {
    const int co = i % kMaxCout;
    ws[i] = co < cout ? w[size_t(i / kMaxCout) * cout + co] : 0.f;
  }

  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * kConvRows;  // the warp's first row of the tile
  const size_t hw = size_t(height) * width;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles_y = (height + kConvTileH - 1) / kConvTileH;
  const int n_tiles = tiles_x * tiles_y * batch;

#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const Tile t = tile_at(tile, tiles_x, tiles_y, kConvTileH);
    const float* xb = x + size_t(t.b) * cin * hw;
    float acc[kConvRows][kMaxCout];
#pragma unroll
    for (int co = 0; co < kMaxCout; ++co) {
      const float bvv = co < cout ? bias[co] : 0.f;
#pragma unroll
      for (int r = 0; r < kConvRows; ++r) acc[r][co] = bvv;
    }

#pragma unroll 1
    for (int c0 = 0; c0 < cin; c0 += kConvChunk) {
      const int nc = min(kConvChunk, cin - c0);
      __syncthreads();  // the previous chunk has been read (and, the first time, ws written)
      for (int i = threadIdx.x; i < nc * kConvPlane; i += kConvThreads) {
        const int col = i % kHaloW;
        const int r = (i / kHaloW) % (kConvTileH + 2);
        const int ci = i / kConvPlane;
        const int gy = t.y0 - 1 + r;
        const int gx = t.x0 - 1 + col;
        float v = 0.f;
        if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
          v = xb[size_t(c0 + ci) * hw + size_t(gy) * width + gx];
        }
        window[i] = v;
      }
      __syncthreads();
#pragma unroll 1
      for (int ci = 0; ci < nc; ++ci) {
        const float* plane = window + ci * kConvPlane + row0 * kHaloW + lane;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float v[kConvRows + 2];
#pragma unroll
          for (int r = 0; r < kConvRows + 2; ++r) v[r] = plane[r * kHaloW + dx];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const float4* w4 = reinterpret_cast<const float4*>(
                ws + ((dy * 3 + dx) * cin + c0 + ci) * kMaxCout);
#pragma unroll
            for (int q = 0; q < kMaxCout / 4; ++q) {
              const float4 wv = w4[q];
#pragma unroll
              for (int r = 0; r < kConvRows; ++r) {
                acc[r][4 * q + 0] = fmaf(v[r + dy], wv.x, acc[r][4 * q + 0]);
                acc[r][4 * q + 1] = fmaf(v[r + dy], wv.y, acc[r][4 * q + 1]);
                acc[r][4 * q + 2] = fmaf(v[r + dy], wv.z, acc[r][4 * q + 2]);
                acc[r][4 * q + 3] = fmaf(v[r + dy], wv.w, acc[r][4 * q + 3]);
              }
            }
          }
        }
      }
    }

    const int gx = t.x0 + lane;
    if (gx < width) {
#pragma unroll
      for (int r = 0; r < kConvRows; ++r) {
        const int gy = t.y0 + row0 + r;
        if (gy < height) {
#pragma unroll
          for (int co = 0; co < kMaxCout; ++co) {
            if (co < cout) {
              out[(size_t(t.b) * cout + co) * hw + size_t(gy) * width + gx] = acc[r][co];
            }
          }
        }
      }
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

// A persistent grid: as many blocks as the card holds at once, at most one a tile.
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, int smem, int device, long long n_tiles,
                    int* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorLaunchOutOfResources);
  *grid = int(n_tiles < (long long)sms * per_sm ? n_tiles : (long long)sms * per_sm);
  return 0;
}

inline bool conv_ok(int batch, int height, int width, int cin, int cout, int tile_h,
                    long long* n_tiles) {
  if (batch <= 0 || height <= 0 || width <= 0 || cin <= 0 || cin > kMaxCin || cout <= 0 ||
      cout > kMaxCout) {
    return false;
  }
  *n_tiles = (long long)((width + kTileW - 1) / kTileW) * ((height + tile_h - 1) / tile_h) *
             batch;
  return *n_tiles <= 0x7fffffff;
}

int launch_conv_f32(const void* x, const void* w, const void* b, void* out, int batch,
                    int height, int width, int cin, int cout, int device, void* stream) {
  long long n_tiles = 0;
  if (!conv_ok(batch, height, width, cin, cout, kConvTileH, &n_tiles)) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int smem = conv_smem(cin);
  int grid = 0;
  const int rc = persistent_grid(cmajor_conv_kernel, kConvThreads, smem, device, n_tiles, &grid);
  if (rc != 0) return rc;
  cmajor_conv_kernel<<<grid, kConvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), batch, height, width, cin, cout);
  return int(cudaGetLastError());
}

int launch_conv_bf16(const void* x, const void* w, const void* b, void* out, int batch,
                     int height, int width, int cin, int cout, int device, void* stream) {
  long long n_tiles = 0;
  if (!conv_ok(batch, height, width, cin, cout, kMmaTileH, &n_tiles)) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int smem = mma_conv_smem(cin);
  int grid = 0;
  const int rc =
      persistent_grid(cmajor_conv_mma_kernel, kMmaThreads, smem, device, n_tiles, &grid);
  if (rc != 0) return rc;
  cmajor_conv_mma_kernel<<<grid, kMmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out), batch, height,
      width, cin, cout);
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
  return launch_conv_f32(x, w, b, out, batch, height, width, cin, cout, device, stream);
}

int satflow_cmajor_conv_bf16(const void* x, const void* w, const void* b, void* out,
                             int batch, int height, int width, int cin, int cout,
                             int device, void* stream) {
  return launch_conv_bf16(x, w, b, out, batch, height, width, cin, cout, device, stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
