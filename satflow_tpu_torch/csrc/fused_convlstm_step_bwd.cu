// Backward of the fused ConvLSTM step (the gate chain) for NVIDIA Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel satflow_tpu/ops/pallas/fused_convlstm_step.py::
// _gate_bwd_pallas (kernel body _make_bwd_kernel). One launch recomputes the
// gate pre-activations of the step with the forward's contraction
//
//   gates = conv3x3_SAME(x, Wx) + conv3x3_SAME(h, Wh) + b     (f32 accumulate)
//
// and runs the gate-chain backward in f32 (_gate_bwd_math):
//
//   si, sf, so = sigmoid(i, f, o);  tg = tanh(g);  c' = sf*c + si*tg;  tc = tanh(c')
//   do  = dh' * tc * so(1-so)
//   dct = dc' + dh' * so * (1 - tc^2)
//   di  = dct * tg * si(1-si);  df = dct * c * sf(1-sf);  dg = dct * si * (1 - tg^2)
//   dc_prev = dct * sf
//
// writing dgates = [di | df | do | dg] (B, H, W, 4Ch) and dc_prev (B, H, W, Ch)
// in the input type (float or bf16). The linear grads (dx, dh, dWx, dWh, db)
// are not this kernel's: the wrapper takes them from library convs of dgates,
// as the JAX package leaves them to XLA.
//
// Ch is 8, 16, 32, 64, 128 or 256 (above 128 in groups of 128 hidden channels,
// as K1); Cx is any width from 1 to 256.
//
// What bounds it on this card: the recompute is K1's contraction, 2 * B*H*W *
// 4Ch * 9(Cx+Ch) FLOP = 0.31 TFLOP at B=8, 256x256, Cx=Ch=64, against ~0.67 GB
// (bf16) of x, h, c, dh', dc' in and dgates, dc_prev out: ~460 FLOP/byte, above
// the ~295 FLOP/byte where an H100 stops being bound by its memory, so the
// call is bound by operations like K1: 0.31 ms at the bf16 tensor cores' peak.
//
// Design: K1's gate pre-activations (convlstm_gates.cuh, one definition for
// both: the tensor cores' mma.sync in bfloat16, f32 FMAs on the CUDA cores in
// float32) with another epilogue. Each thread already holds all four gates of
// each (pixel, channel pair) it owns, so the chain needs no exchange between
// threads; it reads c, dh' and dc' and writes five values per (pixel, channel),
// as pairs. What it leaves on the table is K1's (mma.sync at about half of the
// tensor cores' peak, the weights copied by every block), and its epilogue
// moves twice K1's bytes in 4-byte pieces: staging dgates through the window's
// shared memory would make them 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "convlstm_gates.cuh"

namespace {

using namespace convlstm_gates;

// One element of the chain: writes dgates' four values and returns dc_prev.
__device__ __forceinline__ float gate_chain(float gi, float gf, float go, float gg, float cv,
                                            float dh, float dc, float (&dgate)[4]) {
  const float si = sigmoid(gi);
  const float sf = sigmoid(gf);
  const float so = sigmoid(go);
  const float tg = tanhf(gg);
  const float tc = tanhf(sf * cv + si * tg);
  const float dct = dc + dh * so * (1.f - tc * tc);
  dgate[0] = dct * tg * si * (1.f - si);
  dgate[1] = dct * cv * sf * (1.f - sf);
  dgate[2] = dh * tc * so * (1.f - so);
  dgate[3] = dct * si * (1.f - tg * tg);
  return dct * sf;
}

template <typename T, int CH>
__global__ void __launch_bounds__(kThreads, 1)
gate_bwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                const T* __restrict__ c, const T* __restrict__ wx,
                const T* __restrict__ wh, const T* __restrict__ bias,
                const T* __restrict__ dh_next, const T* __restrict__ dc_next,
                T* __restrict__ dgates, T* __restrict__ dc_prev, int height,
                int width, int cx) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows
  const Tile tile = tile_of_block<CH>();
  const ImageRows<T> src{x, h, tile.b, height, width, cx, CH};
  for_each_gate_pair<T, CH>(
      smem4, tile, src, wx, wh, bias, height, width, cx,
      [&](size_t pixel, int channel, float2 gi, float2 gf, float2 go, float2 gg) {
        const size_t o = pixel * CH + channel;
        const size_t o4 = pixel * (4 * CH) + channel;
        const float2 cv = load_pair(c + o);
        const float2 dh = load_pair(dh_next + o);
        const float2 dc = load_pair(dc_next + o);
        float d0[4], d1[4];
        const float dc0 = gate_chain(gi.x, gf.x, go.x, gg.x, cv.x, dh.x, dc.x, d0);
        const float dc1 = gate_chain(gi.y, gf.y, go.y, gg.y, cv.y, dh.y, dc.y, d1);
#pragma unroll
        for (int g = 0; g < 4; ++g) store_pair(dgates + o4 + g * CH, d0[g], d1[g]);
        store_pair(dc_prev + o, dc0, dc1);
      });
}

template <typename T, int CH>
struct GateBwd {
  static int run(const void* x, const void* h, const void* c, const void* wx,
                 const void* wh, const void* b, const void* dh_next, const void* dc_next,
                 void* dgates, void* dc_prev, int batch, int height, int width, int cx,
                 int device, void* stream) {
    if (!geometry_ok<CH>(batch, height, width, cx)) return int(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const int smem = smem_bytes<T, CH>(cx);
    err = cudaFuncSetAttribute(gate_bwd_kernel<T, CH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    gate_bwd_kernel<T, CH><<<tile_grid<CH>(batch, height, width), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const T*>(c),
        static_cast<const T*>(wx), static_cast<const T*>(wh), static_cast<const T*>(b),
        static_cast<const T*>(dh_next), static_cast<const T*>(dc_next),
        static_cast<T*>(dgates), static_cast<T*>(dc_prev), height, width, cx);
    return int(cudaGetLastError());
  }
};

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* wx,
           const void* wh, const void* b, const void* dh_next, const void* dc_next,
           void* dgates, void* dc_prev, int batch, int height, int width, int cx,
           int ch, int device, void* stream) {
  for (const void* p : {h, c, wx, wh, dh_next, dc_next, static_cast<const void*>(dgates),
                        static_cast<const void*>(dc_prev)}) {
    if (!aligned<T>(p)) return int(cudaErrorMisalignedAddress);
  }
  return launch_for_width<GateBwd, T>(ch, x, h, c, wx, wh, b, dh_next, dc_next, dgates,
                                      dc_prev, batch, height, width, cx, device, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); they launch on `stream` and do not
// synchronise.
extern "C" {

int satflow_gate_bwd_f32(const void* x, const void* h, const void* c, const void* wx,
                         const void* wh, const void* b, const void* dh_next,
                         const void* dc_next, void* dgates, void* dc_prev, int batch,
                         int height, int width, int cx, int ch, int device,
                         void* stream) {
  return launch<float>(x, h, c, wx, wh, b, dh_next, dc_next, dgates, dc_prev, batch,
                       height, width, cx, ch, device, stream);
}

int satflow_gate_bwd_bf16(const void* x, const void* h, const void* c, const void* wx,
                          const void* wh, const void* b, const void* dh_next,
                          const void* dc_next, void* dgates, void* dc_prev, int batch,
                          int height, int width, int cx, int ch, int device,
                          void* stream) {
  return launch<__nv_bfloat16>(x, h, c, wx, wh, b, dh_next, dc_next, dgates, dc_prev,
                               batch, height, width, cx, ch, device, stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
