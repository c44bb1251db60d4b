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
// ops/fused_convlstm_int8.py::pack_weights, K-major: int8 (9, 4Ch, Kp), Kp =
// round_up(Cx, 32) + round_up(Ch, 32), per tap and gate column x's Cx weights,
// zeros, h's Ch weights, zeros: the staged window's byte order, so that each
// column's weights of a k step are two 16-byte copies. Ch is 8, 16, 32, 64 or
// 128; Cx is any width from 1 to 256. The wrapper zero-pads every other Ch to
// the next of these, and Cx to a multiple of 4 (exact: a zero channel of x or
// h and a zero weight column quantize to zeros). The TPU kernel's (W+2)-padded
// carry is dropped: the zeros of SAME padding are written into the staged
// window here.
//
// Exactness. |acc| <= 127 * 127 * 9 * (Cx + Ch) <= 127^2 * 9 * (256 + 128) =
// 5.6e7 < 2^31, so the s32 sums cannot overflow; mma.sync adds the s8 products
// exactly in s32 and needs no .satfinite (none is used). The epilogue rounds
// the product and the sum of the dequantization separately (__fmul_rn,
// __fadd_rn: no fused multiply-add), as the plain version and JAX's
// _step_ref_int8 do.
//
// What bounds it on this card. At the serving shape (B=8, 256x256, Cx=Ch=64)
// one call is 2 * B*H*W * 4Ch * 9(Cx+Ch) = 0.31 TOP against ~0.24 GB moved
// (int8 x, h, h', bf16 c, c'): ~1300 OP/byte, above the ~590 OP/byte at which
// the int8 tensor cores (1979 TOP/s) stop being bound by memory. The call is
// bound by operations: 0.156 ms.
//
// Design. The contraction is convlstm_mma.cuh's, in its S8 type: an implicit
// GEMM per block of tile_rows<Ch>() x 16 pixels on mma.sync m16n8k32 s8 with
// s32 accumulators, over a window staged once as int8 (ImageRows::stage_s8:
// per pixel x's bytes, then h's, each zero-padded to a multiple of 32, and 16
// bytes of padding) and K-major weight slabs in a cp.async ring
// (KMajorWeights, read with a plain ldmatrix: ldmatrix.trans cannot build an
// 8-bit B fragment). The tiles, warps and fragment addresses are the bf16
// K1's, a k step being 32 int8 channels where K1's is 16 bf16 ones. A thread
// ends up with all four gates of each (pixel, channel pair) it owns as s32
// sums, and the epilogue here dequantizes them, runs the exact gate math
// (expf, tanhf) and stores c' (one 4- or 8-byte store) and h'q (2 bytes).
//
// A second entry point writes the integer sums themselves, (B, H, W, 4Ch)
// int32, from the same contraction: how the tests hold the tensor cores' sums
// to the exact ones, bit for bit.
//
// What this design leaves on the table: as K1, the ldmatrix fragment loads
// from shared memory pace mma.sync well under the tensor cores' peak (wgmma
// reads its operands from shared memory); every block copies all the weights
// from L2; the window is staged before the first product, and the epilogue
// runs after the last.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "convlstm_gates.cuh"

namespace {

using namespace convlstm_gates;
using convlstm_mma::KMajorWeights;
using convlstm_mma::round_up_32;
using convlstm_mma::S8;

constexpr float kActScale = 127.f;

template <int CH>
inline int int8_smem_bytes(int cx) {
  return convlstm_mma::smem_bytes<CH, S8, KMajorWeights<CH>>(cx);
}

// The s32 gate sums of the block's tile (see convlstm_mma::for_each_pair for
// what acc holds). Every thread of the block must call it.
template <int CH>
__device__ __forceinline__ void int8_gate_sums(convlstm_mma::Acc<CH, int>& acc, void* smem,
                                               const Tile& tile, const int8_t* __restrict__ xq,
                                               const int8_t* __restrict__ hq,
                                               const int8_t* __restrict__ wk, int height,
                                               int width, int cx) {
  const ImageRows<int8_t> src{xq, hq, tile.b, height, width, cx, CH};
  const int cxp = round_up_32(cx);
  const int chp = round_up_32(CH);
  const KMajorWeights<CH> weights{reinterpret_cast<const unsigned char*>(wk), cxp + chp, cxp,
                                  chp};
  convlstm_mma::gate_preactivations<CH, S8>(acc, static_cast<unsigned char*>(smem), src,
                                            weights, nullptr, tile, cx);
}

template <typename CT, int CH>
__global__ void __launch_bounds__(kThreads, 1)
fused_convlstm_step_int8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ hq,
                                const CT* __restrict__ c, const int8_t* __restrict__ wk,
                                const float* __restrict__ dequant,
                                const float* __restrict__ bias, int8_t* __restrict__ h_out,
                                CT* __restrict__ c_out, int height, int width, int cx) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows
  const Tile tile = tile_of_block<CH>();
  convlstm_mma::Acc<CH, int> acc;
  int8_gate_sums<CH>(acc, smem4, tile, xq, hq, wk, height, width, cx);
  convlstm_mma::for_each_pair<CH>(
      acc, [&](int row, int col, int channel, int2 gi, int2 gf, int2 go, int2 gg) {
        const int gy = tile.y0 + row;
        const int gx = tile.x0 + col;
        if (gy >= height || gx >= width) return;
        const size_t o = ((size_t(tile.b) * height + gy) * width + gx) * CH + channel;
        const int2 sums[4] = {gi, gf, go, gg};
        // a product rounded to f32, then a sum rounded to f32, as the plain
        // version computes it: no fused multiply-add here
        float pre[2][4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int at = g * CH + channel;
          pre[0][g] = __fadd_rn(__fmul_rn(float(sums[g].x), dequant[at]), bias[at]);
          pre[1][g] = __fadd_rn(__fmul_rn(float(sums[g].y), dequant[at + 1]), bias[at + 1]);
        }
        const float2 c_prev = load_pair(c + o);
        float c0, h0, c1, h1;
        lstm_update(pre[0][0], pre[0][1], pre[0][2], pre[0][3], c_prev.x, c0, h0);
        lstm_update(pre[1][0], pre[1][1], pre[1][2], pre[1][3], c_prev.y, c1, h1);
        store_pair(c_out + o, c0, c1);
        // |h'| < 1: in range
        *reinterpret_cast<char2*>(h_out + o) =
            make_char2(static_cast<signed char>(__float2int_rn(h0 * kActScale)),
                       static_cast<signed char>(__float2int_rn(h1 * kActScale)));
      });
}

// The same contraction, its sums written out: sums (B, H, W, 4Ch) int32.
template <int CH>
__global__ void __launch_bounds__(kThreads, 1)
fused_convlstm_int8_sums_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ hq,
                                const int8_t* __restrict__ wk, int* __restrict__ sums,
                                int height, int width, int cx) {
  extern __shared__ float4 smem4[];
  const Tile tile = tile_of_block<CH>();
  convlstm_mma::Acc<CH, int> acc;
  int8_gate_sums<CH>(acc, smem4, tile, xq, hq, wk, height, width, cx);
  convlstm_mma::for_each_pair<CH>(
      acc, [&](int row, int col, int channel, int2 gi, int2 gf, int2 go, int2 gg) {
        const int gy = tile.y0 + row;
        const int gx = tile.x0 + col;
        if (gy >= height || gx >= width) return;
        int* o = sums + ((size_t(tile.b) * height + gy) * width + gx) * (4 * CH) + channel;
        const int2 pairs[4] = {gi, gf, go, gg};
#pragma unroll
        for (int g = 0; g < 4; ++g) *reinterpret_cast<int2*>(o + g * CH) = pairs[g];
      });
}

template <typename F>
int prepare(F kernel, int smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename CT, int CH>
struct Step {
  static int run(const void* xq, const void* hq, const void* c, const void* wk,
                 const void* dequant, const void* bias, void* h_out, void* c_out, int batch,
                 int height, int width, int cx, int device, void* stream) {
    if (!geometry_ok<CH>(batch, height, width, cx)) return int(cudaErrorInvalidValue);
    const int smem = int8_smem_bytes<CH>(cx);
    const int err = prepare(fused_convlstm_step_int8_kernel<CT, CH>, smem, device);
    if (err != cudaSuccess) return err;
    fused_convlstm_step_int8_kernel<CT, CH><<<tile_grid<CH>(batch, height, width), kThreads,
                                              smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(xq), static_cast<const int8_t*>(hq),
        static_cast<const CT*>(c), static_cast<const int8_t*>(wk),
        static_cast<const float*>(dequant), static_cast<const float*>(bias),
        static_cast<int8_t*>(h_out), static_cast<CT*>(c_out), height, width, cx);
    return int(cudaGetLastError());
  }
};

template <typename Unused, int CH>
struct Sums {
  static int run(const void* xq, const void* hq, const void* wk, void* sums, int batch,
                 int height, int width, int cx, int device, void* stream) {
    if (!geometry_ok<CH>(batch, height, width, cx)) return int(cudaErrorInvalidValue);
    const int smem = int8_smem_bytes<CH>(cx);
    const int err = prepare(fused_convlstm_int8_sums_kernel<CH>, smem, device);
    if (err != cudaSuccess) return err;
    fused_convlstm_int8_sums_kernel<CH><<<tile_grid<CH>(batch, height, width), kThreads, smem,
                                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(xq), static_cast<const int8_t*>(hq),
        static_cast<const int8_t*>(wk), static_cast<int*>(sums), height, width, cx);
    return int(cudaGetLastError());
  }
};

// Whether every pointer is a multiple of `bytes`: hq and the packed weights
// are copied 16 bytes at a time, c and c' read and written as pairs (8 bytes
// in float), h'q as 2 bytes, the sums as 8.
inline bool aligned(std::initializer_list<const void*> ptrs, int bytes) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % bytes) return false;
  }
  return true;
}

template <typename CT>
int launch(const void* xq, const void* hq, const void* c, const void* wk, const void* dequant,
           const void* bias, void* h_out, void* c_out, int batch, int height, int width,
           int cx, int ch, int device, void* stream) {
  if (!aligned({hq, wk}, 16) || !aligned({c, c_out}, 2 * sizeof(CT)) || !aligned({h_out}, 2)) {
    return int(cudaErrorMisalignedAddress);
  }
  return launch_for_width<Step, CT, 128>(ch, xq, hq, c, wk, dequant, bias, h_out, c_out, batch,
                                         height, width, cx, device, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes; the suffix is c's type. Each
// returns cudaGetLastError() after the launch (0 on success); they launch on
// `stream` and do not synchronise.
extern "C" {

int satflow_fused_convlstm_step_int8_f32(const void* xq, const void* hq, const void* c,
                                         const void* wk, const void* dequant,
                                         const void* bias, void* h_out, void* c_out,
                                         int batch, int height, int width, int cx, int ch,
                                         int device, void* stream) {
  return launch<float>(xq, hq, c, wk, dequant, bias, h_out, c_out, batch, height, width, cx,
                       ch, device, stream);
}

int satflow_fused_convlstm_step_int8_bf16(const void* xq, const void* hq, const void* c,
                                          const void* wk, const void* dequant,
                                          const void* bias, void* h_out, void* c_out,
                                          int batch, int height, int width, int cx, int ch,
                                          int device, void* stream) {
  return launch<__nv_bfloat16>(xq, hq, c, wk, dequant, bias, h_out, c_out, batch, height,
                               width, cx, ch, device, stream);
}

// The integer gate sums alone: sums (B, H, W, 4Ch) int32.
int satflow_fused_convlstm_int8_sums(const void* xq, const void* hq, const void* wk,
                                     void* sums, int batch, int height, int width, int cx,
                                     int ch, int device, void* stream) {
  if (!aligned({hq, wk}, 16) || !aligned({sums}, 8)) return int(cudaErrorMisalignedAddress);
  return launch_for_width<Sums, int, 128>(ch, xq, hq, wk, sums, batch, height, width, cx,
                                          device, stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
