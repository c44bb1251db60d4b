// int8 fused ConvLSTM step for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel satflow_tpu/ops/pallas/fused_convlstm_int8.py::
// fused_convlstm_step_int8 (kernel body _make_kernel_int8). One launch
// computes, on unpadded NHWC tensors,
//
//   acc   = conv3x3_SAME([xq | hq], wq)                 (int8 x int8 -> int32, exact)
//   accf  = float(acc) * dequant[col] + b[col]          (f32, two roundings)
//   i, f, o, g = split(accf, 4)                         (gate order i, f, o, g)
//   c'    = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
//   h'q   = rint(h' * 127)                              (halves to even, int8)
//
// with f32 gate math, c' stored in c's type (float or bf16). xq (B, H, W, Cx)
// and hq (B, H, W, Ch) are int8; the weights arrive packed by
// ops/fused_convlstm_int8.py::pack_weights as int32 (9, K/4, 4Ch), K = Cx+Ch
// rounded up to 8: tap-major, each int32 the weights of four consecutive
// [x | h] input channels of one output column. Ch is 64 or 128 (a block owns
// 64 hidden channels; at 128 the two groups of 64 are blocks along the grid's
// z axis, each staging the whole window); Cx is any multiple of 4 up to 256.
// The wrapper zero-pads every other width to these (exact: a zero channel of
// x or h and a zero weight column quantize to zeros). The TPU kernel's
// (W+2)-padded carry is dropped: the zeros of SAME padding are written into
// the staged window here.
//
// What bounds it on this card. At the serving shape (B=8, 256x256, Cx=Ch=64)
// one call is 2 * B*H*W * 4Ch * 9(Cx+Ch) = 0.31 TOP against ~0.24 GB moved
// (int8 x, h, h', bf16 c, c'): ~1300 OP/byte, above the ~590 OP/byte at which
// the int8 tensor cores (1979 TOP/s) stop being bound by memory. The call is
// bound by operations.
//
// Design (simple and right first): an 8x16-pixel tile. A block of 8 warps
// stages the tile's 10 x 18 window of [xq | hq] in shared memory as packed
// int8 (one 32-bit word per four channels, zero words for the padding), warp
// w computes tile row w, and lane l owns hidden channels 2l and 2l+1: the
// four gate sums of its 16 pixels x 2 channels sit in 128 int32 registers, so
// the LSTM epilogue needs no exchange between threads. The contraction is
// __dp4a on the CUDA cores: one instruction multiplies four packed channels
// of a pixel (a shared-memory broadcast) with four packed weights (a coalesced
// read through the read-only cache) and adds into the int32 sum.
//
// What this design leaves on the table: __dp4a issues at the integer rate of
// the CUDA cores, a small fraction of what the tensor cores' s8 wgmma / IMMA
// path gives; weights are re-read from L2 by every block; one block per SM
// (register bound) leaves staging and compute unoverlapped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kCh = 64;             // hidden channels a block owns
constexpr int kMaxCh = 128;
constexpr int kTileH = 8;           // output rows per block, one per warp
constexpr int kTileW = 16;          // output columns per block (per warp)
constexpr int kLaneCh = kCh / 32;   // hidden channels per lane
constexpr int kThreads = 32 * kTileH;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kMaxCx = 256;
constexpr float kActScale = 127.f;
static_assert(kLaneCh == 2, "a lane reads its two channels' weights as one int2");

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

// words: 32-bit words per staged pixel, (Cx + Ch rounded up to 8) / 4.
template <typename CT>
__global__ void __launch_bounds__(kThreads, 1)
fused_convlstm_step_int8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ hq,
                                const CT* __restrict__ c, const int2* __restrict__ wp,
                                const float* __restrict__ dequant,
                                const float* __restrict__ bias, int8_t* __restrict__ h_out,
                                CT* __restrict__ c_out, int height, int width, int cx, int ch,
                                int words) {
  extern __shared__ int2 smem2[];  // int2: 8-byte aligned pixel vectors
  int* window = reinterpret_cast<int*>(smem2);
  const int groups = ch / kCh;
  const int b = blockIdx.z / groups;
  const int group = blockIdx.z % groups;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int x_words = cx / 4;
  const int h_words = ch / 4;

  // Stage the (kTileH+2) x (kTileW+2) window of [xq | hq], four channels per
  // word; pixels outside the image and the words that pad K are zero.
  const int n_stage = kHaloH * kHaloW * words;
  for (int i = threadIdx.x; i < n_stage; i += kThreads) {
    const int wi = i % words;
    const int pix = i / words;
    const int gy = y0 - 1 + pix / kHaloW;
    const int gx = x0 - 1 + pix % kHaloW;
    int v = 0;
    if (gy >= 0 && gy < height && gx >= 0 && gx < width && wi < x_words + h_words) {
      const size_t base = (size_t(b) * height + gy) * width + gx;
      v = wi < x_words
              ? __ldg(reinterpret_cast<const int*>(xq + base * cx) + wi)
              : __ldg(reinterpret_cast<const int*>(hq + base * ch) + (wi - x_words));
    }
    window[i] = v;
  }
  __syncthreads();

  const int row = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int co = group * kCh + lane * kLaneCh;  // the first of the lane's two channels

  int acc[kTileW][4][kLaneCh];
#pragma unroll
  for (int p = 0; p < kTileW; ++p) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int j = 0; j < kLaneCh; ++j) acc[p][g][j] = 0;
    }
  }

  // wp as int2: [(tap * words + kg) * 2Ch + g * Ch / 2 + co / 2] holds the
  // packed weights of gate g, channels co and co+1, input channels 4kg..4kg+3.
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int* s = window + ((row + tap / 3) * kHaloW + tap % 3) * words;
    const int2* w = wp + size_t(tap) * words * (2 * ch) + co / 2;
#pragma unroll 1
    for (int kg = 0; kg < words; kg += 2) {
      int2 wr[2][4];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int g = 0; g < 4; ++g) wr[k][g] = __ldg(w + (kg + k) * (2 * ch) + g * (ch / 2));
      }
#pragma unroll
      for (int p = 0; p < kTileW; ++p) {
        // words and kg are even, so the pair of words is 8-byte aligned
        const int2 v = *reinterpret_cast<const int2*>(s + p * words + kg);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[p][g][0] = __dp4a(v.x, wr[0][g].x, acc[p][g][0]);
          acc[p][g][1] = __dp4a(v.x, wr[0][g].y, acc[p][g][1]);
          acc[p][g][0] = __dp4a(v.y, wr[1][g].x, acc[p][g][0]);
          acc[p][g][1] = __dp4a(v.y, wr[1][g].y, acc[p][g][1]);
        }
      }
    }
  }

  const int gy = y0 + row;
  if (gy >= height) return;
  float dq[4][kLaneCh], bv[4][kLaneCh];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int j = 0; j < kLaneCh; ++j) {
      dq[g][j] = dequant[g * ch + co + j];
      bv[g][j] = bias[g * ch + co + j];
    }
  }
#pragma unroll
  for (int p = 0; p < kTileW; ++p) {
    const int gx = x0 + p;
    if (gx < width) {
      const size_t o = ((size_t(b) * height + gy) * width + gx) * ch + co;
      int8_t hq_next[kLaneCh];
#pragma unroll
      for (int j = 0; j < kLaneCh; ++j) {
        // a product rounded to f32, then a sum rounded to f32, as the plain
        // version computes it: no fused multiply-add here
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          pre[g] = __fadd_rn(__fmul_rn(float(acc[p][g][j]), dq[g][j]), bv[g][j]);
        }
        const float c_prev = to_f32(c[o + j]);
        const float c_next = sigmoid(pre[1]) * c_prev + sigmoid(pre[0]) * tanhf(pre[3]);
        const float h_next = sigmoid(pre[2]) * tanhf(c_next);
        c_out[o + j] = from_f32<CT>(c_next);
        hq_next[j] = static_cast<int8_t>(__float2int_rn(h_next * kActScale));  // |h'| < 1
      }
      *reinterpret_cast<char2*>(h_out + o) = make_char2(hq_next[0], hq_next[1]);
    }
  }
}

inline bool shape_ok(int batch, int height, int width, int cx, int ch) {
  return ch % kCh == 0 && ch > 0 && ch <= kMaxCh && cx > 0 && cx % 4 == 0 && cx <= kMaxCx &&
         batch > 0 && batch * (ch / kCh) <= 65535 && height > 0 && width > 0 &&
         (height + kTileH - 1) / kTileH <= 65535;
}

template <typename CT>
int launch(const void* xq, const void* hq, const void* c, const void* wp,
           const void* dequant, const void* bias, void* h_out, void* c_out, int batch,
           int height, int width, int cx, int ch, int device, void* stream) {
  if (!shape_ok(batch, height, width, cx, ch)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int words = (cx + ch + 7) / 8 * 2;
  const int smem = kHaloH * kHaloW * words * int(sizeof(int));
  err = cudaFuncSetAttribute(fused_convlstm_step_int8_kernel<CT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH,
                  batch * (ch / kCh));
  fused_convlstm_step_int8_kernel<CT><<<grid, kThreads, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(hq),
      static_cast<const CT*>(c), static_cast<const int2*>(wp),
      static_cast<const float*>(dequant), static_cast<const float*>(bias),
      static_cast<int8_t*>(h_out), static_cast<CT*>(c_out), height, width, cx, ch, words);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes; the suffix is c's type. Each
// returns cudaGetLastError() after the launch (0 on success); they launch on
// `stream` and do not synchronise.
extern "C" {

int satflow_fused_convlstm_step_int8_f32(const void* xq, const void* hq, const void* c,
                                         const void* wp, const void* dequant,
                                         const void* bias, void* h_out, void* c_out,
                                         int batch, int height, int width, int cx, int ch,
                                         int device, void* stream) {
  return launch<float>(xq, hq, c, wp, dequant, bias, h_out, c_out, batch, height, width,
                       cx, ch, device, stream);
}

int satflow_fused_convlstm_step_int8_bf16(const void* xq, const void* hq, const void* c,
                                          const void* wp, const void* dequant,
                                          const void* bias, void* h_out, void* c_out,
                                          int batch, int height, int width, int cx, int ch,
                                          int device, void* stream) {
  return launch<__nv_bfloat16>(xq, hq, c, wp, dequant, bias, h_out, c_out, batch, height,
                               width, cx, ch, device, stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
