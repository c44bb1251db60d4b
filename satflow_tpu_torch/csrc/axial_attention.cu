// Batched single-axis attention for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel satflow_tpu/ops/pallas/axial_attention.py::
// _attention_pallas (kernel body _kernel). For every batch row n of (N, L, D)
// operands q, k, v it computes
//
//   out[n] = softmax((q[n] * D^-0.5) k[n]^T) v[n]
//
// with f32 math and the output stored in the input type (float or bf16). As
// in the plain version, q * scale is rounded to the input type before the
// product; the wrapper passes scale = D^-0.5 as the f32 the plain version
// multiplies by. Domain: the one the JAX dispatcher admits, 1 <= L <= 512 and
// 1 <= D <= 256; any N.
//
// What bounds it on this card. Per row, 4 L^2 D flops against 4 L D elements
// of q, k, v, out: L flops per byte in bf16. At MetNet's shape (N = 24,576,
// L = 16, D = 8) that is ~16 FLOP/byte (memory: ~25 MB in bf16, ~8 us at
// 3.35 TB/s); at the long-axis shapes (L = 256..512, D = 64..256) it is
// 256-512 FLOP/byte, at or above the ~295 where the card stops being bound by
// its memory, so there the f32 CUDA-core arithmetic bounds it.
//
// Design (simple and right first). A block of 8 warps takes one batch row n
// and 8 query rows, one per warp, and walks the keys in tiles of 32 staged in
// shared memory as f32, with an online softmax (running max and sum), so the
// L x L scores never leave the chip and any L up to 512 fits. Per tile, lane j
// scores key j against the warp's query row (keys stored with an odd row
// stride, so the 32 lanes read 32 different banks); the warp reduces the
// tile's max and sum with shuffles; then each lane accumulates the output
// elements d = lane + 32 m (at most 8 f32 registers for D = 256) over the
// tile's keys, each key's weight broadcast by a shuffle. What it leaves on
// the table: the tensor cores (mma.sync or wgmma on the two products), and
// reuse of a staged key tile across more than 8 query rows (every block of a
// row n stages all of k[n] and v[n] again).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;                 // query rows per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kTileKeys = 32;             // keys per staged tile, one per lane
constexpr int kMaxL = 512;
constexpr int kMaxD = 256;
constexpr int kOutPerLane = kMaxD / 32;   // output elements a lane accumulates
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Row stride of the staged keys: odd, so lane j's reads of row j hit bank
// (j * stride + d) % 32, a different bank for every lane.
__host__ __device__ __forceinline__ int key_stride(int d) { return d | 1; }

__host__ __device__ __forceinline__ int smem_floats(int d) {
  return kTileKeys * key_stride(d) + kTileKeys * d + kWarps * d;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
axial_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int len, int dim,
                       float scale) {
  extern __shared__ float smem[];
  const int ks = key_stride(dim);
  float* k_s = smem;                      // [kTileKeys][ks]
  float* v_s = k_s + kTileKeys * ks;      // [kTileKeys][dim]
  float* q_s = v_s + kTileKeys * dim;     // [kWarps][dim]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t base = int64_t(blockIdx.x) * len * dim;  // row n of q, k, v, out
  const int row = blockIdx.y * kWarps + warp;              // this warp's query row
  const bool active = row < len;
  float* q_w = q_s + warp * dim;
  if (active) {
    for (int d = lane; d < dim; d += 32) {
      // q * scale rounded to T, as the plain version computes it
      q_w[d] = to_f32(from_f32<T>(to_f32(q[base + int64_t(row) * dim + d]) * scale));
    }
  }

  float m = -INFINITY;  // running max of the scores
  float l = 0.f;        // running sum of exp(score - m)
  float acc[kOutPerLane];
#pragma unroll
  for (int i = 0; i < kOutPerLane; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < len; k0 += kTileKeys) {
    const int nk = min(kTileKeys, len - k0);
    __syncthreads();  // the previous tile has been read by every warp
    for (int e = threadIdx.x; e < nk * dim; e += kThreads) {
      const int j = e / dim;
      const int d = e - j * dim;
      const int64_t src = base + int64_t(k0 + j) * dim + d;
      k_s[j * ks + d] = to_f32(k[src]);
      v_s[j * dim + d] = to_f32(v[src]);
    }
    __syncthreads();
    if (!active) continue;  // every thread still reaches both barriers of each tile

    float s = -INFINITY;
    if (lane < nk) {
      const float* k_row = k_s + lane * ks;
      s = 0.f;
      for (int d = 0; d < dim; ++d) s = fmaf(q_w[d], k_row[d], s);
    }
    const float m_new = fmaxf(m, warp_max(s));  // finite: nk >= 1
    const float p = lane < nk ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);         // 0 on the first tile
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int i = 0; i < kOutPerLane; ++i) acc[i] *= corr;
    for (int j = 0; j < nk; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
      const float* v_row = v_s + j * dim;
#pragma unroll
      for (int i = 0; i < kOutPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < dim) acc[i] = fmaf(pj, v_row[d], acc[i]);
      }
    }
    m = m_new;
  }

  if (active) {
    T* o = out + base + int64_t(row) * dim;
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < kOutPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < dim) o[d] = from_f32<T>(acc[i] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int64_t n, int len,
           int dim, float scale, int device, void* stream) {
  if (n < 1 || n > 0x7fffffff || len < 1 || len > kMaxL || dim < 1 || dim > kMaxD) {
    return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int smem = smem_floats(dim) * int(sizeof(float));
  err = cudaFuncSetAttribute(axial_attention_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned(n), unsigned((len + kWarps - 1) / kWarps));
  axial_attention_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), len, dim, scale);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); they launch on `stream` and do not
// synchronise.
extern "C" {

int satflow_axial_attention_f32(const void* q, const void* k, const void* v, void* out,
                                int64_t n, int len, int dim, float scale, int device,
                                void* stream) {
  return launch<float>(q, k, v, out, n, len, dim, scale, device, stream);
}

int satflow_axial_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                 int64_t n, int len, int dim, float scale, int device,
                                 void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, n, len, dim, scale, device, stream);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
