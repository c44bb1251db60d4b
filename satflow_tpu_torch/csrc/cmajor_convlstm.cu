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
// exists to feed its matrix unit and has no use here. Ch is 8, 16, 32, 64 or
// 128 (the wrapper zero-pads another width to the next of them); Cx is any
// width from 1 to 256.
//
// K6b, the head:  out = conv3x3_SAME(x, W) + b, x (B, Cin, H*W), W (3, 3, Cin,
// Cout) HWIO, out (B, Cout, H*W); Cin <= 128, Cout <= 16.
//
// What bounds them on this card. K6a at the serving shape (B=8, 256x256,
// Cx=Ch=64) is the same 0.31 TFLOP against ~0.34 GB as the NHWC step (K1):
// ~900 FLOP/byte, bound by operations. K6b (64 -> 12 channels) is 7.2 GFLOP
// against ~80 MB: ~90 FLOP/byte, bound by the bytes it moves.
//
// Design, K6a: the NHWC step's (K1's) contraction, with a channel-major
// source for its window (convlstm_gates.cuh, CmajorRows in
// convlstm_source.cuh). A block of 8 warps owns tile_rows<Ch>() x 16 pixels
// and all Ch hidden channels. bfloat16 contracts on the tensor cores, an
// implicit GEMM with M = pixels, N = 4Ch, K = 9 x (Cx + Ch) on mma.sync
// (convlstm_mma.cuh): the channel-major window is staged transposed into a
// [pixel][channel] bf16 tile by 16-byte loads of 8 pixels of 8 channel planes
// and byte permutes in registers (the route K6b takes), so that a tap is a row
// offset of the window, as in K1. The epilogue reads c and writes h', c'
// through a per-warp [channel][pixel] buffer in shared memory (over the
// window, once every warp is done with it; convlstm_gates.cuh::
// cmajor_lstm_bf16, shared with T3): a warp reads and writes each channel
// plane as runs of 16 neighbouring pixels, and a thread turns the four gates
// of its (pixel, channel pair) into h' and c' with no exchange between
// threads. float32 keeps the f32 FMAs on the CUDA cores (convlstm_tile.cuh)
// and stores h', c' by the element.
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
//   the whole window where W % 8 != 0) are staged by the element
//   (convlstm_source.cuh::stage_cmajor_bf16, which K6a's window shares). A block of 8
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
// What this design leaves on the table: K6a leaves K1's (mma.sync at about
// half of the tensor cores' peak, the weights copied from L2 by every block,
// the window staged before the first product), and its halo columns are
// staged by the element. The bf16 K6b stages a tile's window with plain loads
// before its first product (two blocks on an SM overlap each other, nothing
// overlaps within a block), its halo columns cost a 32-byte sector per 2-byte
// element, and N = 16 leaves the tensor cores mostly idle: it is bound by
// staging, not by the 24 us its bytes need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "convlstm_gates.cuh"

namespace {

using convlstm_mma::ldmatrix_x4;
using convlstm_mma::ldmatrix_x4_trans;
using convlstm_mma::mma_bf16;
using convlstm_mma::round_up_16;
using convlstm_mma::smem_addr;

constexpr int kTileW = 32;          // K6b: one column per lane
constexpr int kHaloW = kTileW + 2;

// K6b
constexpr int kMaxCin = 128;
constexpr int kMaxCout = 16;
// bfloat16: 8 warps, a warp one row of 32 pixels
constexpr int kMmaTileH = 8;
constexpr int kMmaThreads = 32 * kMmaTileH;
static_assert(kMmaThreads == convlstm_tile::kThreads, "the window is staged by a block of these");
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

template <typename T, int CH>
__global__ void __launch_bounds__(convlstm_tile::kThreads, 1)
cmajor_cell_kernel(const T* __restrict__ x, const T* __restrict__ h, const T* __restrict__ c,
                   const T* __restrict__ wx, const T* __restrict__ wh,
                   const T* __restrict__ bias, T* __restrict__ h_out, T* __restrict__ c_out,
                   int height, int width, int cx) {
  using convlstm_tile::lstm_update;
  extern __shared__ float4 smem4[];
  const convlstm_tile::Tile tile = convlstm_tile::tile_of_block<CH>();
  const convlstm_source::CmajorRows<T> src{x, h, tile.b, height, width, cx, CH};
  const size_t hw = size_t(height) * width;
  if constexpr (!convlstm_gates::kTensorCores<T>) {
    convlstm_gates::for_each_gate_pair<T, CH>(
        smem4, tile, src, wx, wh, bias, height, width, cx,
        [&](size_t pixel, int channel, float2 gi, float2 gf, float2 go, float2 gg) {
          const size_t o = (size_t(tile.b) * CH + channel) * hw + (pixel - size_t(tile.b) * hw);
          float c_next, h_next;
          lstm_update(gi.x, gf.x, go.x, gg.x, c[o], c_next, h_next);
          c_out[o] = c_next;
          h_out[o] = h_next;
          lstm_update(gi.y, gf.y, go.y, gg.y, c[o + hw], c_next, h_next);
          c_out[o + hw] = c_next;
          h_out[o + hw] = h_next;
        });
  } else {
    unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
    convlstm_mma::Acc<CH> acc;
    convlstm_mma::gate_preactivations<CH, convlstm_mma::Bf16>(
        acc, smem, src, convlstm_mma::HwioWeights<CH>{wx, wh}, bias, tile, cx);
    __syncthreads();  // every warp is done with the window: the buffers go over it
    convlstm_gates::cmajor_lstm_bf16<CH>(acc, smem, tile, c, h_out, c_out, height, width, 0);
  }
}

template <typename T, int CH>
inline int cell_smem(int cx) {
  const int gates = convlstm_gates::smem_bytes<T, CH>(cx);
  if constexpr (convlstm_gates::kTensorCores<T>) {
    constexpr int kEpilogue = convlstm_gates::CmajorEpilogue<CH>::kBytes;
    return gates > kEpilogue ? gates : kEpilogue;
  } else {
    return gates;
  }
}

template <typename T, int CH>
struct Cell {
  static int run(const void* x, const void* h, const void* c, const void* wx, const void* wh,
                 const void* b, void* h_out, void* c_out, int batch, int height, int width,
                 int cx, int device, void* stream) {
    if (!convlstm_gates::geometry_ok<CH>(batch, height, width, cx)) {
      return int(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const int smem = cell_smem<T, CH>(cx);
    err = cudaFuncSetAttribute(cmajor_cell_kernel<T, CH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    cmajor_cell_kernel<T, CH><<<convlstm_tile::tile_grid<CH>(batch, height, width),
                                convlstm_tile::kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const T*>(c),
        static_cast<const T*>(wx), static_cast<const T*>(wh), static_cast<const T*>(b),
        static_cast<T*>(h_out), static_cast<T*>(c_out), height, width, cx);
    return int(cudaGetLastError());
  }
};

template <typename T>
int launch_cell(const void* x, const void* h, const void* c, const void* wx, const void* wh,
                const void* b, void* h_out, void* c_out, int batch, int height, int width,
                int cx, int ch, int device, void* stream) {
  for (const void* p : {wx, wh}) {  // the weight slabs are copied 16 bytes at a time
    if (reinterpret_cast<uintptr_t>(p) % 16) return int(cudaErrorMisalignedAddress);
  }
  return convlstm_gates::launch_for_width<Cell, T, 128>(ch, x, h, c, wx, wh, b, h_out, c_out,
                                                       batch, height, width, cx, device,
                                                       stream);
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

    convlstm_source::stage_cmajor_bf16<kHaloW>(
        window, pitch, ncg, kMmaTileH + 2, height, width, t.y0, t.x0, vec,
        [&](int cg, int& n) {
          n = cin - cg * 8;
          return xb + size_t(cg * 8) * hw;
        },
        [&](int ci, int gy, int gx) {
          const bool in = ci < cin && gy >= 0 && gy < height && gx >= 0 && gx < width;
          return in ? __bfloat162float(xb[size_t(ci) * hw + size_t(gy) * width + gx]) : 0.f;
        });
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
