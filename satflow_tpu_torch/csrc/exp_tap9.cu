// Two study formulations of the fused ConvLSTM step for NVIDIA Hopper
// (sm_90a), and their yardstick, hand-written CUDA C++. Three kernels from one
// template.
//
// Replaces the TPU kernels of tools/exp_tap9.py: step_tap9 (kernel body
// _make_kernel_tap9), here T1, and step_nogate (kernel body
// _make_kernel_nogate), here T2. The yardstick the JAX tool times them
// against is its main kernel in the same layout (_step_pallas_padded); here
// it is the template's third instance, K1p: the main step's contraction order
// and LSTM epilogue behind the same staging as T1 and T2, so that a difference
// between the three is the order or the epilogue and nothing else. All keep
// the JAX main path's W-padded I/O, the only kernels of the port that do: xp (B, H, W+2, Cx) and hp (B, H, W+2,
// Ch) carry one halo column on either side, which the kernel reads as given
// (the caller keeps it zero); c and c' are (B, H, W, Ch); h' leaves as (B, H,
// W+2, Ch) with its two halo columns written as zeros, ready to be the next
// step's hp. The rows above and below the image are the zeros of SAME padding.
//
// T1, tap-major: one channel concat [x | h] is staged once, and the step is
// nine contractions of depth K = Cx + Ch, one per (dy, dx) tap, against
//   w9 (9, Cx+Ch, 4Ch),  w9[dy*3+dx] = [Wx[dy, dx] ; Wh[dy, dx]],
// the tap loop outermost and K innermost; then the LSTM epilogue
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c').
//
// T2, no gate math: the main kernel's contraction order, per dy the three dx
// taps of x and then the three of h against
//   w3 (3, 3Cx+3Ch, 4Ch),  w3[dy] = [Wx[dy, 0..2] ; Wh[dy, 0..2]],
// the bias, and an epilogue of adds only:
//   c' = acc[0:Ch] + c;  h' = acc[Ch:2Ch] + c'.
// T2 exists for one number: the step's time without its expf and tanhf.
//
// K1p: w3 as T2, the LSTM epilogue as T1.
//
// Ch is 8, 16, 32, 64 or 128 and Cx a multiple of 4 up to 256 (the wrappers
// zero-pad other widths to these). The tile, the thread layout and the inner
// product are those of convlstm_tile.cuh at CH (tile_rows<CH>() x 16 pixels a
// block; at CH = 64 a thread owns the four gates of 16 pixels x 2 channels).
// What bounds them on this card: operations (0.31 TFLOP against ~0.34 GB at
// B=8, 256x256, Cx=Ch=64); the contraction is f32 FMAs on the CUDA cores in
// both dtypes and leaves the tensor cores unused: the three are measurements
// of that contraction, which the float32 K1 still runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "convlstm_gates.cuh"

namespace {

using namespace convlstm_gates;

// kTapMajor: w is w9 and each tap is one contraction over [x | h] (T1); else w
// is w3 and each tap is two, x's then h's (T2's, K1p's and the main kernel's
// order). kGates: the LSTM epilogue (T1, K1p); else the add-only one (T2).
// `unused_sums` is null in every launch. T2's epilogue reads only half of the
// accumulator columns; it would store the other half there, which keeps the
// compiler from dropping that half of the contraction: the whole contraction
// is what T2 is there to time.
template <typename T, int CH, bool kTapMajor, bool kGates>
__global__ void __launch_bounds__(kThreads, 1)
padded_step_kernel(const T* __restrict__ xp, const T* __restrict__ hp,
                   const T* __restrict__ c, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ hp_out,
                   T* __restrict__ c_out, float* __restrict__ unused_sums, int height,
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
          if (unused_sums != nullptr) unused_sums[oc + j] = acc[p][2][j] + acc[p][3][j];
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

template <typename T, bool kTapMajor, bool kGates>
struct Padded {
  template <typename U, int CH>
  struct Step {
    static int run(const void* xp, const void* hp, const void* c, const void* w, const void* b,
                   void* hp_out, void* c_out, int batch, int height, int width, int cx,
                   int device, void* stream) {
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
              static_cast<U*>(c_out), static_cast<float*>(nullptr), height, width, cx);
      return int(cudaGetLastError());
    }
  };
};

template <typename T, bool kTapMajor, bool kGates>
int launch(const void* xp, const void* hp, const void* c, const void* w, const void* b,
           void* hp_out, void* c_out, int batch, int height, int width, int cx, int ch,
           int device, void* stream) {
  return launch_for_width<Padded<T, kTapMajor, kGates>::template Step, T, 128>(
      ch, xp, hp, c, w, b, hp_out, c_out, batch, height, width, cx, device, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); they launch on `stream` and do not
// synchronise. `width` is the unpadded W.
extern "C" {

#define SATFLOW_PADDED_STEP_ENTRY(name, T, tap_major, gates)                                \
  int name(const void* xp, const void* hp, const void* c, const void* w, const void* b,    \
           void* hp_out, void* c_out, int batch, int height, int width, int cx, int ch,    \
           int device, void* stream) {                                                     \
    return launch<T, tap_major, gates>(xp, hp, c, w, b, hp_out, c_out, batch, height,      \
                                       width, cx, ch, device, stream);                     \
  }

SATFLOW_PADDED_STEP_ENTRY(satflow_step_tap9_f32, float, true, true)
SATFLOW_PADDED_STEP_ENTRY(satflow_step_tap9_bf16, __nv_bfloat16, true, true)
SATFLOW_PADDED_STEP_ENTRY(satflow_step_nogate_f32, float, false, false)
SATFLOW_PADDED_STEP_ENTRY(satflow_step_nogate_bf16, __nv_bfloat16, false, false)
SATFLOW_PADDED_STEP_ENTRY(satflow_step_padded_f32, float, false, true)
SATFLOW_PADDED_STEP_ENTRY(satflow_step_padded_bf16, __nv_bfloat16, false, true)

#undef SATFLOW_PADDED_STEP_ENTRY

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
