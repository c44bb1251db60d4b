// Two study formulations of the fused ConvLSTM step for NVIDIA Hopper
// (sm_90a), and their yardstick, hand-written CUDA C++. Three kernels from one
// template in each dtype.
//
// Replaces the TPU kernels of tools/exp_tap9.py: step_tap9 (kernel body
// _make_kernel_tap9), here T1, and step_nogate (kernel body
// _make_kernel_nogate), here T2. The yardstick the JAX tool times them
// against is its main kernel in the same layout (_step_pallas_padded); here
// it is the template's third instance, K1p: the main step's contraction order
// and LSTM epilogue behind the same staging as T1 and T2, so that a difference
// between the three is the order or the epilogue and nothing else. All keep
// the JAX main path's W-padded I/O, the only kernels of the port that do: xp
// (B, H, W+2, Cx) and hp (B, H, W+2, Ch) carry one halo column on either side,
// which the kernel reads as given (the caller keeps it zero); c and c' are (B,
// H, W, Ch); h' leaves as (B, H, W+2, Ch) with its two halo columns written as
// zeros, ready to be the next step's hp. The rows above and below the image
// are the zeros of SAME padding.
//
// T1, tap-major: the channel concat [x | h] is staged once, and the step is
// nine contractions of depth K = Cx + Ch, one per (dy, dx) tap, against
//   w9 (9, Cx+Ch, 4Ch),  w9[dy*3+dx] = [Wx[dy, dx] ; Wh[dy, dx]],
// the tap loop outermost and K innermost; then the LSTM epilogue
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c').
//
// T2, no gate math: the contraction against
//   w3 (3, 3Cx+3Ch, 4Ch),  w3[dy] = [Wx[dy, 0..2] ; Wh[dy, 0..2]],
// the bias, and an epilogue of adds only on gate slots 0 and 1:
//   c' = acc[0:Ch] + c;  h' = acc[Ch:2Ch] + c'.
// T2 exists for one number: the step's time without its expf and tanhf. Its
// sums entry point also writes the two slots the epilogue does not read,
// o + g = acc[2Ch:3Ch] + acc[3Ch:4Ch] (f32, (B, H, W, Ch)), so that a test can
// hold the whole contraction.
//
// K1p: w3 as T2, the LSTM epilogue as T1.
//
// The order each walks K in:
//   bfloat16  T1 tap by tap, x's channels then h's of each tap (the order of
//             K1's bf16 contraction); T2 and K1p the JAX main kernel's
//             (fused_convlstm_step.py's im2col): per dy, x's channels of the
//             taps dx = 0, 1, 2, then h's of the same three taps. Each reads
//             its weight tensor front to back, so T1 against K1p is the order
//             on the tensor cores and nothing else.
//   float32   all three tap by tap; T1 contracts [x | h] of a tap in one
//             pass, T2 and K1p x's channels and then h's, on w3's rows.
//
// Ch is 8, 16, 32, 64 or 128 and Cx a multiple of 4 up to 256 (the wrappers
// zero-pad other widths to these).
//
// Design, bfloat16: the contraction of the served steps (convlstm_mma.cuh,
// K1's, not a copy): an implicit GEMM per block of tile_rows<Ch>() x 16
// pixels on mma.sync m16n8k16 with f32 sums, the window staged once by
// cp.async from convlstm_source.cuh::PadColumns (the halo columns read as
// given), w9 and w3 read as given through StridedWeights (a (base, sy, sx)
// of rows for x and one for h, computed by the wrapper), in the order of Walk
// (T1) or RowWalk (T2, K1p). The epilogue works on the (pixel, channel pair)
// fragments that for_each_pair hands over, as K1's does, and stores h' at
// padded column x + 1.
//
// Design, float32 (unchanged since the port; the f32 tolerance allows no bf16
// products): the tile, the thread layout and the inner product of
// convlstm_tile.cuh at Ch (tile_rows<Ch>() x 16 pixels a block; at Ch = 64 a
// thread owns the four gates of 16 pixels x 2 channels), f32 FMAs on the
// CUDA cores.
//
// What bounds them on this card: operations (0.31 TFLOP against ~0.34 GB at
// B=8, 256x256, Cx=Ch=64); the bf16 steps leave what K1 leaves (mma.sync paced
// by its fragment loads, the window staged before the first product, the
// exact epilogue after the last), the f32 steps run on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "convlstm_gates.cuh"

namespace {

using namespace convlstm_gates;
using convlstm_mma::RowStrides;

// float32, on the CUDA cores. kTapMajor: w is w9 and each tap is one
// contraction over [x | h] (T1); else w is w3 and each tap is two, x's then
// h's (T2, K1p). kGates: the LSTM epilogue (T1, K1p); else the add-only one
// (T2), which also writes o + g to `sums` where it is not null.
template <typename T, int CH, bool kTapMajor, bool kGates>
__global__ void __launch_bounds__(kThreads, 1)
padded_step_kernel(const T* __restrict__ xp, const T* __restrict__ hp,
                   const T* __restrict__ c, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ hp_out,
                   T* __restrict__ c_out, float* __restrict__ sums, int height,
                   int width, int cx) {
  using L = Lanes<CH>;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows
  float* window = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * tile_rows<CH>();
  const int x0 = blockIdx.x * kTileW;
  const int cin = cx + CH;   // per staged pixel: x channels, then h channels
  const int wp = width + 2;  // padded row length

  // Stage the (tile_rows + 2) x (kTileW + 2) window of the channel concat
  // [x | h] as f32. Window column j is padded column x0 + j: the halo columns
  // come from the tensors themselves; only rows outside the image are written
  // as zeros.
  const int n_stage = (tile_rows<CH>() + 2) * kHaloW * cin;
  for (int i = threadIdx.x; i < n_stage; i += kThreads) {
    const int ci = i % cin;
    const int pix = i / cin;
    const int gy = y0 - 1 + pix / kHaloW;
    const int px = x0 + pix % kHaloW;
    float v = 0.f;
    if (gy >= 0 && gy < height && px < wp) {
      const size_t base = (size_t(b) * height + gy) * wp + px;
      v = ci < cx ? to_f32(xp[base * cx + ci]) : to_f32(hp[base * CH + (ci - cx)]);
    }
    window[i] = v;
  }
  __syncthreads();

  const int row = L::row();
  const int p0 = L::pixel0();
  const int co = L::channel();
  float acc[L::kPix][4][kLaneCh];
  init_with_bias<CH>(acc, bias, co);

#pragma unroll 1
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll 1
    for (int kx = 0; kx < 3; ++kx) {
      const float* s = window + ((row + ky) * kHaloW + kx + p0) * cin;
      if constexpr (kTapMajor) {
        accumulate<CH>(acc, s, cin, w + size_t(ky * 3 + kx) * cin * (4 * CH) + co, cin);
      } else {
        const T* w_dy = w + size_t(ky) * (3 * cin) * (4 * CH) + co;
        accumulate<CH>(acc, s, cin, w_dy + size_t(kx) * cx * (4 * CH), cx);
        accumulate<CH>(acc, s + cx, cin, w_dy + (size_t(3) * cx + size_t(kx) * CH) * (4 * CH), CH);
      }
    }
  }

  const int gy = y0 + row;
  if (gy >= height) return;
  const size_t row_c = (size_t(b) * height + gy) * width;
  const size_t row_h = (size_t(b) * height + gy) * wp;
#pragma unroll
  for (int p = 0; p < L::kPix; ++p) {
    const int gx = x0 + p0 + p;
    if (gx < width) {
      const size_t oc = (row_c + gx) * CH + co;
      const size_t oh = (row_h + gx + 1) * CH + co;
#pragma unroll
      for (int j = 0; j < kLaneCh; ++j) {
        const float c_prev = to_f32(c[oc + j]);
        float c_next, h_next;
        if constexpr (kGates) {
          lstm_update(acc[p][0][j], acc[p][1][j], acc[p][2][j], acc[p][3][j], c_prev, c_next,
                      h_next);
        } else {
          // gate slots 0 and 1 are accumulator columns [0, Ch) and [Ch, 2Ch)
          c_next = acc[p][0][j] + c_prev;
          h_next = acc[p][1][j] + c_next;
          if (sums != nullptr) sums[oc + j] = acc[p][2][j] + acc[p][3][j];
        }
        c_out[oc + j] = from_f32<T>(c_next);
        hp_out[oh + j] = from_f32<T>(h_next);
      }
    }
  }
  // The output's two halo columns, zeros, by the threads of the first pixel
  // group: the first column tile writes column 0, the tile that holds the
  // image's last column writes column W+1.
  if (p0 != 0) return;
  const T zero = from_f32<T>(0.f);
  if (x0 == 0) {
#pragma unroll
    for (int j = 0; j < kLaneCh; ++j) hp_out[row_h * CH + co + j] = zero;
  }
  if (x0 + kTileW >= width) {
#pragma unroll
    for (int j = 0; j < kLaneCh; ++j) hp_out[(row_h + width + 1) * CH + co + j] = zero;
  }
}

// bfloat16, on the tensor cores. kRowOrder: K in the JAX main kernel's order
// (RowWalk: T2, K1p), else tap by tap (Walk: T1); the weights are w9 or w3 as
// x_rows and h_rows find their rows. kGates as above; o + g goes to `sums`
// where it is not null (T2).
template <int CH, bool kRowOrder, bool kGates>
__global__ void __launch_bounds__(kThreads, 1)
padded_mma_kernel(const __nv_bfloat16* __restrict__ xp, const __nv_bfloat16* __restrict__ hp,
                  const __nv_bfloat16* __restrict__ c, const __nv_bfloat16* __restrict__ w,
                  const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ hp_out,
                  __nv_bfloat16* __restrict__ c_out, float* __restrict__ sums, int height,
                  int width, int cx, RowStrides x_rows, RowStrides h_rows) {
  using Order = typename std::conditional<kRowOrder, convlstm_mma::RowWalk<CH>,
                                          convlstm_mma::Walk>::type;
  extern __shared__ float4 smem4[];
  const Tile tile = tile_of_block<CH>();
  const PadColumns<__nv_bfloat16> src{xp, hp, tile.b, height, width, cx, CH};
  const convlstm_mma::StridedWeights<CH> weights{w, x_rows, h_rows};
  convlstm_mma::Acc<CH> acc;
  convlstm_mma::gate_preactivations<CH, convlstm_mma::Bf16, Order>(
      acc, reinterpret_cast<unsigned char*>(smem4), src, weights, bias, tile, cx);
  const int wp = width + 2;  // padded row length
  convlstm_mma::for_each_pair<CH>(
      acc, [&](int row, int col, int channel, float2 gi, float2 gf, float2 go, float2 gg) {
        const int gy = tile.y0 + row;
        const int gx = tile.x0 + col;
        if (gy >= height || gx >= width) return;
        const size_t image_row = size_t(tile.b) * height + gy;
        const size_t oc = (image_row * width + gx) * CH + channel;
        const size_t oh = (image_row * wp + gx + 1) * CH + channel;
        const float2 c_prev = load_pair(c + oc);
        float2 c_next, h_next;
        if constexpr (kGates) {
          lstm_update(gi.x, gf.x, go.x, gg.x, c_prev.x, c_next.x, h_next.x);
          lstm_update(gi.y, gf.y, go.y, gg.y, c_prev.y, c_next.y, h_next.y);
        } else {
          // gate slots 0 and 1
          c_next = make_float2(gi.x + c_prev.x, gi.y + c_prev.y);
          h_next = make_float2(gf.x + c_next.x, gf.y + c_next.y);
          if (sums != nullptr) store_pair(sums + oc, go.x + gg.x, go.y + gg.y);
        }
        store_pair(c_out + oc, c_next.x, c_next.y);
        store_pair(hp_out + oh, h_next.x, h_next.y);
      });
  // The output's two halo columns, zeros: the first column tile writes column
  // 0 of its rows, the tile that holds the image's last column writes W+1.
  const bool first = tile.x0 == 0;
  const bool last = tile.x0 + kTileW >= width;
  if (!first && !last) return;
  constexpr int kPairs = CH / 2;  // channel pairs a pixel
  for (int i = threadIdx.x; i < tile_rows<CH>() * kPairs; i += kThreads) {
    const int gy = tile.y0 + i / kPairs;
    if (gy >= height) break;
    const size_t row_h = (size_t(tile.b) * height + gy) * wp;
    const int channel = i % kPairs * 2;
    if (first) store_pair(hp_out + row_h * CH + channel, 0.f, 0.f);
    if (last) store_pair(hp_out + (row_h + width + 1) * CH + channel, 0.f, 0.f);
  }
}

template <bool kTapMajor, bool kGates>
struct PaddedF32 {
  template <typename U, int CH>
  struct Step {
    static int run(const void* xp, const void* hp, const void* c, const void* w, const void* b,
                   void* hp_out, void* c_out, void* sums, int batch, int height, int width,
                   int cx, int device, void* stream) {
      if (cx <= 0 || cx % 4 != 0 || cx > kMaxCx || !grid_ok<CH>(batch, height, width)) {
        return int(cudaErrorInvalidValue);
      }
      cudaError_t err = cudaSetDevice(device);
      if (err != cudaSuccess) return int(err);
      const int smem = window_bytes<CH>(cx);
      err = cudaFuncSetAttribute(padded_step_kernel<U, CH, kTapMajor, kGates>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return int(err);
      padded_step_kernel<U, CH, kTapMajor, kGates>
          <<<tile_grid<CH>(batch, height, width), kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
              static_cast<const U*>(xp), static_cast<const U*>(hp), static_cast<const U*>(c),
              static_cast<const U*>(w), static_cast<const U*>(b), static_cast<U*>(hp_out),
              static_cast<U*>(c_out), static_cast<float*>(sums), height, width, cx);
      return int(cudaGetLastError());
    }
  };
};

template <bool kRowOrder, bool kGates>
struct PaddedMma {
  template <typename U, int CH>
  struct Step {
    static int run(const void* xp, const void* hp, const void* c, const void* w, const void* b,
                   void* hp_out, void* c_out, void* sums, int batch, int height, int width,
                   int cx, RowStrides x_rows, RowStrides h_rows, int device, void* stream) {
      if (cx <= 0 || cx > kMaxCx || !grid_ok<CH>(batch, height, width)) {
        return int(cudaErrorInvalidValue);
      }
      // the window's h pieces and the weight slabs are copied 16 bytes at a
      // time (x's where its rows allow); c and the outputs go in pairs
      for (const void* p : {hp, c, w, static_cast<const void*>(hp_out),
                            static_cast<const void*>(c_out), static_cast<const void*>(sums)}) {
        if (reinterpret_cast<uintptr_t>(p) % 16) return int(cudaErrorMisalignedAddress);
      }
      cudaError_t err = cudaSetDevice(device);
      if (err != cudaSuccess) return int(err);
      const int smem = convlstm_mma::smem_bytes<CH, convlstm_mma::Bf16,
                                                convlstm_mma::StridedWeights<CH>>(cx);
      err = cudaFuncSetAttribute(padded_mma_kernel<CH, kRowOrder, kGates>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return int(err);
      padded_mma_kernel<CH, kRowOrder, kGates>
          <<<tile_grid<CH>(batch, height, width), kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
              static_cast<const __nv_bfloat16*>(xp), static_cast<const __nv_bfloat16*>(hp),
              static_cast<const __nv_bfloat16*>(c), static_cast<const __nv_bfloat16*>(w),
              static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(hp_out),
              static_cast<__nv_bfloat16*>(c_out), static_cast<float*>(sums), height, width, cx,
              x_rows, h_rows);
      return int(cudaGetLastError());
    }
  };
};

// T1 is tap-major on w9 in both dtypes; T2 and K1p walk w3 (in bf16 in the
// JAX main kernel's order).
template <bool kTapMajor, bool kGates>
int launch_f32(const void* xp, const void* hp, const void* c, const void* w, const void* b,
               void* hp_out, void* c_out, void* sums, int batch, int height, int width, int cx,
               int ch, int device, void* stream) {
  return launch_for_width<PaddedF32<kTapMajor, kGates>::template Step, float, 128>(
      ch, xp, hp, c, w, b, hp_out, c_out, sums, batch, height, width, cx, device, stream);
}

template <bool kTapMajor, bool kGates>
int launch_bf16(const void* xp, const void* hp, const void* c, const void* w, const void* b,
                void* hp_out, void* c_out, void* sums, int batch, int height, int width, int cx,
                int ch, int x_base, int x_sy, int x_sx, int h_base, int h_sy, int h_sx,
                int device, void* stream) {
  return launch_for_width<PaddedMma<!kTapMajor, kGates>::template Step, __nv_bfloat16, 128>(
      ch, xp, hp, c, w, b, hp_out, c_out, sums, batch, height, width, cx,
      RowStrides{x_base, x_sy, x_sx}, RowStrides{h_base, h_sy, h_sx}, device, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); they launch on `stream` and do not
// synchronise. `width` is the unpadded W. The bf16 entries also take where
// the weights' rows are: the row of x's channel k at tap (ky, kx) is x_base +
// ky * x_sy + kx * x_sx + k, h's alike. The *_sums_* entries are T2 that also
// writes o + g to `sums` (f32, (B, H, W, Ch)).
extern "C" {

#define SATFLOW_PADDED_F32_ENTRY(name, tap_major, gates)                                    \
  int name(const void* xp, const void* hp, const void* c, const void* w, const void* b,    \
           void* hp_out, void* c_out, int batch, int height, int width, int cx, int ch,    \
           int device, void* stream) {                                                     \
    return launch_f32<tap_major, gates>(xp, hp, c, w, b, hp_out, c_out, nullptr, batch,    \
                                        height, width, cx, ch, device, stream);            \
  }
#define SATFLOW_PADDED_BF16_ENTRY(name, tap_major, gates)                                   \
  int name(const void* xp, const void* hp, const void* c, const void* w, const void* b,    \
           void* hp_out, void* c_out, int batch, int height, int width, int cx, int ch,    \
           int x_base, int x_sy, int x_sx, int h_base, int h_sy, int h_sx, int device,      \
           void* stream) {                                                                 \
    return launch_bf16<tap_major, gates>(xp, hp, c, w, b, hp_out, c_out, nullptr, batch,   \
                                         height, width, cx, ch, x_base, x_sy, x_sx, h_base, \
                                         h_sy, h_sx, device, stream);                      \
  }

SATFLOW_PADDED_F32_ENTRY(satflow_step_tap9_f32, true, true)
SATFLOW_PADDED_BF16_ENTRY(satflow_step_tap9_bf16, true, true)
SATFLOW_PADDED_F32_ENTRY(satflow_step_nogate_f32, false, false)
SATFLOW_PADDED_BF16_ENTRY(satflow_step_nogate_bf16, false, false)
SATFLOW_PADDED_F32_ENTRY(satflow_step_padded_f32, false, true)
SATFLOW_PADDED_BF16_ENTRY(satflow_step_padded_bf16, false, true)

#undef SATFLOW_PADDED_F32_ENTRY
#undef SATFLOW_PADDED_BF16_ENTRY

int satflow_step_nogate_sums_f32(const void* xp, const void* hp, const void* c, const void* w,
                                 const void* b, void* hp_out, void* c_out, void* sums,
                                 int batch, int height, int width, int cx, int ch, int device,
                                 void* stream) {
  return launch_f32<false, false>(xp, hp, c, w, b, hp_out, c_out, sums, batch, height, width,
                                  cx, ch, device, stream);
}

int satflow_step_nogate_sums_bf16(const void* xp, const void* hp, const void* c, const void* w,
                                  const void* b, void* hp_out, void* c_out, void* sums,
                                  int batch, int height, int width, int cx, int ch, int x_base,
                                  int x_sy, int x_sx, int h_base, int h_sy, int h_sx,
                                  int device, void* stream) {
  return launch_bf16<false, false>(xp, hp, c, w, b, hp_out, c_out, sums, batch, height, width,
                                   cx, ch, x_base, x_sy, x_sx, h_base, h_sy, h_sx, device,
                                   stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
