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
//   of the next step. Tiles that fall on pad rows only do no contraction.
//   Only the W boundary is masked while staging;
// - the weights are w9 (9, 4C, Cx+Ch): per (dy, dx) tap, gate-major rows (i,
//   f, o, g, each C wide) with the contraction axis [x ; h] fastest; b is
//   (4C, 1).
//
// C is the same for x and h (the prototype's Cx == Ch): 8, 16, 32, 64 or 128
// (the wrapper zero-pads another width to the next of them); block_h is a
// multiple of 4 and H a multiple of block_h.
//
// Design, bfloat16: the contraction of the served steps (convlstm_mma.cuh,
// K1's and K6a's, not a copy): an implicit GEMM per block of tile_rows<C>() x
// 16 pixels on mma.sync m16n8k16 with f32 sums. The window comes from
// convlstm_source.cuh::PadRows: K6a's transposed staging (8 pixels x 8
// channel planes a thread, 16-byte loads and byte permutes into a
// [pixel][channel] tile) over planes of SP elements, the tile's rows counted
// from the first pad row, so that the pad rows above and below the image
// are the real zeros of SAME padding. w9 is already K-major (each gate
// column's [x ; h] weights of a tap contiguous), so it is read as given
// through the contraction's KMajorWeights path, a plain ldmatrix, with no
// repacking. h' and c' leave through K6a's per-warp [channel][pixel] buffer
// (convlstm_gates.cuh::cmajor_lstm_bf16), which writes the tile's pad rows
// as zeros. The grid covers the padded rows in tiles of 8 (4 at C = 128), so
// a tile may straddle the boundary between pad and image rows (block_h = 4
// or 12); a tile of pad rows only writes zeros and contracts nothing.
//
// Design, float32 (simple and right first; the f32 tolerance allows no bf16
// products, so it stays on the CUDA cores). A block owns a tile of 4 rows x 32
// columns of the padded image and stages its 6 x 34 window, one plane per
// input channel, as f32 in shared memory (104 KB at C = 64, 204 KB at 128).
// One warp per 8 hidden channels, up to 64 channels a block (above, the groups
// of 64 are blocks along the grid's z axis, each staging the whole window);
// lane l owns column l of the 4 rows, warp w hidden channels 8w..8w+7 of the
// block's, so a thread holds the four gates of 4 pixels x 8 channels in 128
// f32 registers and the epilogue needs no exchange. With the contraction axis
// fastest, a thread reads its weights four input channels at a time: per tap
// and group of four input channels it loads the 16 window values once, then
// for each of its 32 (gate, channel) rows one 16-byte vector, the same
// address for the whole warp, and issues 16 FMAs.
//
// What bounds it on this card: operations, as K6a (0.31 TFLOP against ~0.40
// GB with the pad rows at B=8, 256x256, block_h 8). The bf16 step leaves what
// K6a leaves (mma.sync paced by its fragment loads, the window staged before
// the first product, the halo columns by the element); the f32 step runs on
// the CUDA cores (67 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "convlstm_gates.cuh"

namespace {

constexpr int kTileH = 4;
constexpr int kTileW = 32;          // one column per lane
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kPlane = kHaloH * kHaloW;
constexpr int kWarpCh = 8;          // hidden channels per warp
constexpr int kKv = 4;              // input channels per weight vector

// The block's geometry at C channels: kBlockC hidden channels (one warp per
// 8), kGroups blocks per image along z, contraction depth kK = 2C a tap.
template <int C>
struct Geometry {
  static_assert(C == 8 || C == 16 || C == 32 || C == 64 || C == 128, "channel widths built");
  static constexpr int kBlockC = C < 64 ? C : 64;
  static constexpr int kGroups = C / kBlockC;
  static constexpr int kK = 2 * C;
  static constexpr int kThreads = 32 * (kBlockC / kWarpCh);
};

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Four adjacent weights along the contraction axis.
__device__ __forceinline__ void load4(float (&out)[kKv], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

// float32, on the CUDA cores.
template <int C>
__global__ void __launch_bounds__(Geometry<C>::kThreads, 1)
exp_cmajor_step_kernel(const float* __restrict__ x, const float* __restrict__ h,
                       const float* __restrict__ c, const float* __restrict__ w9,
                       const float* __restrict__ bias, float* __restrict__ h_out,
                       float* __restrict__ c_out, int height, int width, int block_h) {
  using G = Geometry<C>;
  constexpr int kC = C;
  constexpr int kK = G::kK;
  constexpr int kThreads = G::kThreads;
  extern __shared__ float4 smem4[];
  float* window = reinterpret_cast<float*>(smem4);  // kK planes: x's, then h's
  const int b = blockIdx.z / G::kGroups;
  const int py0 = blockIdx.y * kTileH;  // first padded row of the tile
  const int x0 = blockIdx.x * kTileW;
  const int lane = threadIdx.x % 32;
  const int ch0 = (blockIdx.z % G::kGroups) * G::kBlockC + (threadIdx.x / 32) * kWarpCh;
  const int gx = x0 + lane;
  const size_t sp = size_t(height + 2 * block_h) * width;

  // A tile on pad rows: zeros out, no contraction. block_h is a multiple of
  // the tile height, so a tile is all pad or all image.
  if (py0 < block_h || py0 >= block_h + height) {
    if (gx < width) {
#pragma unroll
      for (int r = 0; r < kTileH; ++r) {
#pragma unroll
        for (int j = 0; j < kWarpCh; ++j) {
          const size_t o = (size_t(b) * kC + ch0 + j) * sp + size_t(py0 + r) * width + gx;
          h_out[o] = 0.f;
          c_out[o] = 0.f;
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
      const float* src = k < kC ? x : h;
      v = src[(size_t(b) * kC + (k % kC)) * sp + size_t(py0 - 1 + r) * width + sx];
    }
    window[i] = v;
  }
  __syncthreads();

  float acc[kTileH][4][kWarpCh];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int j = 0; j < kWarpCh; ++j) {
      const float bv = bias[g * kC + ch0 + j];
#pragma unroll
      for (int r = 0; r < kTileH; ++r) acc[r][g][j] = bv;
    }
  }

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap % 3;
    const float* w_tap = w9 + size_t(tap) * (4 * kC) * kK + size_t(ch0) * kK;
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
      const float c_prev = c[o];
      const float c_next = sigmoid(acc[r][1][j]) * c_prev +
                           sigmoid(acc[r][0][j]) * tanhf(acc[r][3][j]);
      const float h_next = sigmoid(acc[r][2][j]) * tanhf(c_next);
      c_out[o] = c_next;
      h_out[o] = h_next;
    }
  }
}

// bfloat16, on the tensor cores: the tile's rows count from the first pad
// row (see PadRows).
template <int C>
__global__ void __launch_bounds__(convlstm_tile::kThreads, 1)
exp_cmajor_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                      const __nv_bfloat16* __restrict__ c, const __nv_bfloat16* __restrict__ w9,
                      const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ h_out,
                      __nv_bfloat16* __restrict__ c_out, int height, int width, int block_h) {
  using convlstm_tile::kTileW;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const convlstm_tile::Tile tile = convlstm_tile::tile_of_block<C>();
  constexpr int kRows = convlstm_tile::tile_rows<C>();
  const int rows = height + 2 * block_h;
  if (tile.y0 + kRows <= block_h || tile.y0 >= block_h + height) {
    // pad rows only: zeros out, no contraction
    const size_t plane = size_t(rows) * width;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < C * kRows * kTileW; i += convlstm_tile::kThreads) {
      const int gy = tile.y0 + i / kTileW % kRows;
      const int gx = tile.x0 + i % kTileW;
      if (gy < rows && gx < width) {
        const size_t o = (size_t(tile.b) * C + i / (kRows * kTileW)) * plane +
                         size_t(gy) * width + gx;
        h_out[o] = zero;
        c_out[o] = zero;
      }
    }
    return;
  }
  const convlstm_source::PadRows<__nv_bfloat16> src(x, h, tile.b, rows, width, C);
  // w9 as given: per tap, 4C gate columns of [x ; h], 2C bf16 each
  const convlstm_mma::KMajorWeights<C> weights{reinterpret_cast<const unsigned char*>(w9),
                                               4 * C, 2 * C, 2 * C};
  convlstm_mma::Acc<C> acc;
  convlstm_mma::gate_preactivations<C, convlstm_mma::Bf16>(acc, smem, src, weights, bias, tile,
                                                           C);
  __syncthreads();  // every warp is done with the window: the buffers go over it
  convlstm_gates::cmajor_lstm_bf16<C>(acc, smem, tile, c, h_out, c_out, rows, width, block_h);
}

inline bool geometry_ok(int batch, int groups, int height, int width, int block_h) {
  return batch > 0 && batch * groups <= 65535 && height > 0 && width > 0 && block_h > 0 &&
         block_h % kTileH == 0 && height % block_h == 0 &&
         (height + 2 * block_h) / kTileH <= 65535;
}

template <typename T, int C>
struct Step;

template <int C>
struct Step<float, C> {
  static int run(const void* x, const void* h, const void* c, const void* w9, const void* b,
                 void* h_out, void* c_out, int batch, int height, int width, int block_h,
                 int device, void* stream) {
    using G = Geometry<C>;
    if (!geometry_ok(batch, G::kGroups, height, width, block_h)) {
      return int(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const int smem = G::kK * kPlane * int(sizeof(float));
    err = cudaFuncSetAttribute(exp_cmajor_step_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((width + kTileW - 1) / kTileW, (height + 2 * block_h) / kTileH,
                    batch * G::kGroups);
    exp_cmajor_step_kernel<C><<<grid, G::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(h),
        static_cast<const float*>(c), static_cast<const float*>(w9),
        static_cast<const float*>(b), static_cast<float*>(h_out), static_cast<float*>(c_out),
        height, width, block_h);
    return int(cudaGetLastError());
  }
};

template <int C>
struct Step<__nv_bfloat16, C> {
  static int run(const void* x, const void* h, const void* c, const void* w9, const void* b,
                 void* h_out, void* c_out, int batch, int height, int width, int block_h,
                 int device, void* stream) {
    const int rows = height + 2 * block_h;
    if (!geometry_ok(batch, 1, height, width, block_h) ||
        !convlstm_tile::grid_ok<C>(batch, rows, width)) {
      return int(cudaErrorInvalidValue);
    }
    // the weight slabs are copied 16 bytes at a time; x and h are read so
    // where their rows allow
    for (const void* p : {x, h, w9}) {
      if (reinterpret_cast<uintptr_t>(p) % 16) return int(cudaErrorMisalignedAddress);
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const int gates = convlstm_mma::smem_bytes<C, convlstm_mma::Bf16,
                                               convlstm_mma::KMajorWeights<C>>(C);
    constexpr int kEpilogue = convlstm_gates::CmajorEpilogue<C>::kBytes;
    const int smem = gates > kEpilogue ? gates : kEpilogue;
    err = cudaFuncSetAttribute(exp_cmajor_mma_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    exp_cmajor_mma_kernel<C><<<convlstm_tile::tile_grid<C>(batch, rows, width),
                               convlstm_tile::kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(c), static_cast<const __nv_bfloat16*>(w9),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(h_out),
        static_cast<__nv_bfloat16*>(c_out), height, width, block_h);
    return int(cudaGetLastError());
  }
};

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* w9, const void* b,
           void* h_out, void* c_out, int batch, int height, int width, int channels,
           int block_h, int device, void* stream) {
  return convlstm_gates::launch_for_width<Step, T, 128>(channels, x, h, c, w9, b, h_out, c_out,
                                                        batch, height, width, block_h, device,
                                                        stream);
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
