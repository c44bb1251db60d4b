// Batched single-axis attention for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel satflow_tpu/ops/pallas/axial_attention.py::
// _attention_pallas (kernel body _kernel). For every batch row n of (N, L, D)
// operands q, k, v it computes
//
//   out[n] = softmax((q[n] * D^-0.5) k[n]^T) v[n]
//
// with an f32 softmax and the output stored in the input type (float or bf16).
// As in the plain version, q * scale is rounded to the input type before the
// product; the wrapper passes scale = D^-0.5 as the f32 the plain version
// multiplies by. Domain: the one the JAX dispatcher admits, 1 <= L <= 512 and
// 1 <= D <= 256; any N.
//
// What bounds it on this card. Per row, 4 L^2 D flops against 4 L D elements
// of q, k, v, out: L flops per byte in bf16. At MetNet's shape (N = 24,576,
// L = 16, D = 8) that is ~16 FLOP/byte (memory: ~25 MB in bf16, ~8 us at
// 3.35 TB/s); at the long-axis shapes (L = 256..512, D = 64..256) it is
// 256-512 FLOP/byte, at or above the ~295 where the card stops being bound by
// its memory, so there the arithmetic bounds it.
//
// Three kernels; the wrapper's rule on (L, D, dtype) picks one (ops/
// axial_attention.py::regime, repeated in launch() below):
//
// "rows" (L <= 32 and D <= 32, both types): short axes of thin heads. A block
// of 256 threads takes R = 256 / L consecutive batch rows n, which are
// contiguous in memory, stages their k and v in shared memory in the input
// type (16-byte copies where D fills its bucket), and one thread owns one
// (n, query row): q in registers, the row's L scores in registers, a one-pass
// softmax, p v from shared memory (the threads of one n read the same key: a
// broadcast), one store of the output row. No shuffles, no rescaling, one
// barrier. Templated on the buckets of L (16, 32) and D (8, 16, 32) so that
// every loop unrolls into registers.
//
// "mma" (bfloat16 outside "rows"): both products on the tensor cores with
// mma.sync m16n8k16, f32 sums. A block of 4 warps takes one n and 64 x MT
// query rows (a warp 16 x MT; MT = 2 up to D = 64 on axes longer than 64, else
// 1). The q tile is staged once and scaled in shared memory; its fragments
// then stay in registers up to D = 128. k and v arrive in tiles of KT keys (64,
// or 32 at D = 256) as bf16 through a cp.async ring of three stages (two from
// D = 128 on), one barrier a tile, zero-filled past L and past D. S = q k^T
// comes from ldmatrix fragments of both; the online softmax runs on the
// accumulator fragments (row max and sum across the quad by two shuffles,
// exp as one multiply-add and one ex2); p is repacked from the S accumulators
// as the A fragments of p v without touching shared memory; v's B fragments
// come from ldmatrix.trans. D is padded to its bucket (16, 32, 64, 128, 256)
// with zeros. bf16 products in f32 are exact, so the scores equal the plain
// version's up to summation order; p rounded to bf16 for the second product
// adds at most 2^-9 relative per weight, which the bfloat16 tolerance holds
// without splitting p into two bf16 parts. The output rows leave through the
// warp's own rows of the q tile, as 16-byte stores where D % 8 == 0.
//
// "tile" (float32 outside "rows"): f32 FMAs on the CUDA cores, as the
// tolerance against the plain version (1e-5) demands, as two register-tiled
// products. A block of 256 threads (16 x 16) takes one n and 64 query rows and
// walks the keys in tiles of 64; q (times scale), k, v and the tile's softmax
// weights lie in shared memory as f32, D padded to 64, 128 or 256 with zeros.
// Thread (ty, tx) owns the 4 x 4 scores of rows 4 ty + i against keys tx + 16 j
// (16-byte reads along d: 8 reads for 64 FMAs); a row's 64 scores lie in one
// half-warp, so the online softmax needs four shuffles a reduction; the
// weights go to shared memory, and the same thread then accumulates its 4 rows
// x 4 columns of each 64-column chunk of the output from 16-byte reads of the
// weights and of v.
//
// What is left on the table: wgmma and a warp-specialised producer for the
// "mma" kernel (its fragment loads take most of shared memory's bandwidth); at
// D = 256 a warp owns one m16 tile only, so k's and v's fragments are loaded
// once per 16 query rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxL = 512;
constexpr int kMaxD = 256;
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

// q * scale rounded to T, as the plain version computes it
template <typename T>
__device__ __forceinline__ float scaled_q(T v, float scale) {
  return to_f32(from_f32<T>(to_f32(v) * scale));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---------------------------------------------------------------------------
// "rows": one thread per (n, query row)
// ---------------------------------------------------------------------------

constexpr int kRowsThreads = 256;

// DB values of a staged row (16-byte aligned) as f32
template <int DB>
__device__ __forceinline__ void load_row(float (&out)[DB], const float* p) {
#pragma unroll
  for (int i = 0; i < DB / 4; ++i) {
    const float4 a = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = a.x; out[4 * i + 1] = a.y; out[4 * i + 2] = a.z; out[4 * i + 3] = a.w;
  }
}
template <int DB>
__device__ __forceinline__ void load_row(float (&out)[DB], const __nv_bfloat16* p) {
  // bf16 is the high half of an f32: widen both halves of each 32-bit word
#pragma unroll
  for (int i = 0; i < DB / 8; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      out[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// Bytes of one n's staged k (or v): L rows of DB elements and 16 bytes, so
// that two n of a warp start in different banks.
template <typename T, int DB>
__host__ __device__ inline int rows_block_bytes(int len) {
  return len * DB * int(sizeof(T)) + 16;
}

template <typename T, int LB, int DB>
__global__ void __launch_bounds__(kRowsThreads)
axial_attention_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out, long long n_rows,
                            int len, int dim, float scale) {
  extern __shared__ uint4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int per_block = kRowsThreads / len;  // batch rows n a block takes
  const int stride = rows_block_bytes<T, DB>(len);
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + per_block * stride;

  const long long n0 = (long long)blockIdx.x * per_block;
  const int n_here = int(min((long long)per_block, n_rows - n0));
  const size_t base = size_t(n0) * len * dim;  // the block's first element of q, k, v, out
  const bool whole = dim == DB && aligned16(k) && aligned16(v) && aligned16(q) &&
                     aligned16(out) && (size_t(len) * dim * sizeof(T)) % 16 == 0;

  if (whole) {
    // the n of a block are contiguous: 16-byte copies, neighbouring threads
    // on neighbouring pieces
    constexpr int kPer = 16 / int(sizeof(T));
    const int pieces_n = len * DB / kPer;  // pieces of one n
    for (int i = threadIdx.x; i < n_here * pieces_n; i += kRowsThreads) {
      const int n = i / pieces_n;
      const int piece = i - n * pieces_n;
      const size_t src = base + size_t(i) * kPer;
      reinterpret_cast<uint4*>(k_s + n * stride)[piece] = *reinterpret_cast<const uint4*>(k + src);
      reinterpret_cast<uint4*>(v_s + n * stride)[piece] = *reinterpret_cast<const uint4*>(v + src);
    }
  } else {
    for (int i = threadIdx.x; i < n_here * len * DB; i += kRowsThreads) {
      const int d = i % DB;
      const int row = i / DB;  // n * len + j
      const int n = row / len;
      const int j = row - n * len;
      const bool in = d < dim;
      const size_t src = base + size_t(row) * dim + d;
      reinterpret_cast<T*>(k_s + n * stride)[j * DB + d] = in ? k[src] : from_f32<T>(0.f);
      reinterpret_cast<T*>(v_s + n * stride)[j * DB + d] = in ? v[src] : from_f32<T>(0.f);
    }
  }
  __syncthreads();

  const int n = threadIdx.x / len;
  const int row = threadIdx.x - n * len;
  if (n >= n_here) return;
  const size_t mine = base + (size_t(n) * len + row) * dim;

  float qv[DB];
  if (whole) {
    load_row<DB>(qv, q + mine);
#pragma unroll
    for (int d = 0; d < DB; ++d) qv[d] = scaled_q<T>(from_f32<T>(qv[d]), scale);
  } else {
#pragma unroll
    for (int d = 0; d < DB; ++d) qv[d] = d < dim ? scaled_q<T>(q[mine + d], scale) : 0.f;
  }

  const T* k_n = reinterpret_cast<const T*>(k_s + n * stride);
  const T* v_n = reinterpret_cast<const T*>(v_s + n * stride);
  float s[LB];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < LB; ++j) {
    s[j] = -INFINITY;
    if (j < len) {
      float kv[DB];
      load_row<DB>(kv, k_n + j * DB);
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < DB; ++d) a = fmaf(qv[d], kv[d], a);
      s[j] = a;
      m = fmaxf(m, a);
    }
  }
  float l = 0.f;
  float acc[DB];
#pragma unroll
  for (int d = 0; d < DB; ++d) acc[d] = 0.f;
#pragma unroll
  for (int j = 0; j < LB; ++j) {
    if (j < len) {
      const float p = expf(s[j] - m);
      l += p;
      float vv[DB];
      load_row<DB>(vv, v_n + j * DB);
#pragma unroll
      for (int d = 0; d < DB; ++d) acc[d] = fmaf(p, vv[d], acc[d]);
    }
  }
  const float inv = 1.f / l;
  if (whole) {
    __align__(16) T o[DB];
#pragma unroll
    for (int d = 0; d < DB; ++d) o[d] = from_f32<T>(acc[d] * inv);
    constexpr int kPieces = DB * int(sizeof(T)) / 16;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      reinterpret_cast<uint4*>(out + mine)[i] = reinterpret_cast<const uint4*>(o)[i];
    }
  } else {
#pragma unroll
    for (int d = 0; d < DB; ++d) {
      if (d < dim) out[mine + d] = from_f32<T>(acc[d] * inv);
    }
  }
}

template <typename T, int LB, int DB>
int launch_rows(const T* q, const T* k, const T* v, T* out, int64_t n, int len, int dim,
                float scale, cudaStream_t stream) {
  const int per_block = kRowsThreads / len;
  const int smem = 2 * per_block * rows_block_bytes<T, DB>(len);
  cudaError_t err = cudaFuncSetAttribute(axial_attention_rows_kernel<T, LB, DB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const unsigned grid = unsigned((n + per_block - 1) / per_block);
  axial_attention_rows_kernel<T, LB, DB><<<grid, kRowsThreads, smem, stream>>>(
      q, k, v, out, (long long)n, len, dim, scale);
  return int(cudaGetLastError());
}

template <typename T, int LB>
int launch_rows_d(const T* q, const T* k, const T* v, T* out, int64_t n, int len, int dim,
                  float scale, cudaStream_t stream) {
  if (dim <= 8) return launch_rows<T, LB, 8>(q, k, v, out, n, len, dim, scale, stream);
  if (dim <= 16) return launch_rows<T, LB, 16>(q, k, v, out, n, len, dim, scale, stream);
  return launch_rows<T, LB, 32>(q, k, v, out, n, len, dim, scale, stream);
}

// ---------------------------------------------------------------------------
// "mma": bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

// The tile shape at D bucket DP: MT m16 tiles of query rows a warp (two where
// the registers allow it and the axis is longer than one block of one: k's
// and v's fragments then serve 32 query rows), KT keys a staged tile. The
// accumulators of a thread are MT * (DP / 2 + KT / 2) f32.
template <int DP, int MT>
struct MmaShape {
  static_assert(MT == 1 || (MT == 2 && DP <= 64), "two m16 tiles a warp only up to D = 64");
  static constexpr int kMT = MT;
  static constexpr int kKT = DP <= 128 ? 64 : 32;
  // q's A fragments stay in registers across the key tiles where they fit
  static constexpr bool kQInRegs = DP <= 128;
  static constexpr int kRows = 16 * kMT * kMmaWarps;  // query rows a block
  static constexpr int kPitch = DP * 2 + 16;          // bytes a staged row: ldmatrix's 8 rows
                                                      // fall in different banks
  // k and v tiles in flight: a ring of kStages stages, kStages - 1 copies ahead
  static constexpr int kStages = DP <= 64 ? 3 : 2;
  static constexpr int kSmem = (kRows + 2 * kStages * kKT) * kPitch;  // q, then the ring
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, or 16 bytes of zeros where !valid (src is then not read).
__device__ __forceinline__ void cp_async_16_or_zeros(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Four 8x8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a (16 x 16, row-major) * b (16 x 8, column-major), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two f32 as one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// two bf16 of q, each times scale and rounded to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float scale) {
  return pack_bf16(__uint_as_float(w << 16) * scale, __uint_as_float(w & 0xffff0000u) * scale);
}
// 2^x; 0 for x = -inf
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

template <int DP, int MT>
__global__ void __launch_bounds__(kMmaThreads)
axial_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           int len, int dim, float scale) {
  using S = MmaShape<DP, MT>;
  constexpr int kMT = S::kMT, kKT = S::kKT, kPitch = S::kPitch;
  constexpr int kNS = kKT / 8;   // n8 tiles of scores a key tile
  constexpr int kND = DP / 8;    // n8 tiles of the output
  constexpr int kPieces = DP / 8;  // 16-byte pieces a staged row
  extern __shared__ uint4 smem4[];
  unsigned char* q_s = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* kv_s = q_s + S::kRows * kPitch;  // stage s: k at 2s, v at 2s + 1

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // the blocks of one n are neighbours in the grid, so that they run together
  // and k[n], v[n] come from HBM once and from L2 after that
  const int row_tiles = (len + S::kRows - 1) / S::kRows;
  const size_t base = size_t(blockIdx.x / row_tiles) * len * dim;  // row n of q, k, v, out
  const int row0 = (blockIdx.x % row_tiles) * S::kRows;            // the block's first query row
  const bool vec = dim % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);

  const int n_tiles = (len + kKT - 1) / kKT;
  // rows [first, first + rows) of src (row n) into dst, zeros past len and dim.
  // A thread copies the same 16-byte piece of every (128 / kPieces)-th row, so
  // that its addresses advance by constants.
  constexpr int kRowsPerPass = kMmaThreads / kPieces;
  static_assert(kMmaThreads % kPieces == 0 && kKT % kRowsPerPass == 0, "whole passes");
  const int piece = threadIdx.x % kPieces;
  const int piece_row = threadIdx.x / kPieces;
  const bool piece_valid = piece * 8 < dim;
  auto stage = [&](unsigned char* dst, const __nv_bfloat16* src, int first, int rows) {
    if (vec) {
      const __nv_bfloat16* from = src + base + size_t(first + piece_row) * dim + piece * 8;
      unsigned char* to = dst + piece_row * kPitch + piece * 16;
      if (first + rows <= len) {
#pragma unroll
        for (int r = 0; r < rows; r += kRowsPerPass) {
          cp_async_16_or_zeros(to + r * kPitch, piece_valid ? from + size_t(r) * dim : src,
                               piece_valid);
        }
      } else {
#pragma unroll
        for (int r = 0; r < rows; r += kRowsPerPass) {
          const bool valid = piece_valid && first + piece_row + r < len;
          cp_async_16_or_zeros(to + r * kPitch, valid ? from + size_t(r) * dim : src, valid);
        }
      }
    } else {
      for (int i = threadIdx.x; i < rows * DP; i += kMmaThreads) {
        const int r = i / DP;
        const int d = i - r * DP;
        const bool valid = first + r < len && d < dim;
        reinterpret_cast<__nv_bfloat16*>(dst + r * kPitch)[d] =
            valid ? src[base + size_t(first + r) * dim + d] : __float2bfloat16(0.f);
      }
    }
  };
  // The ring's next tile: running source addresses and stage, advanced by
  // constants, so that a copy costs an add and the copy itself.
  const unsigned char* k_from = reinterpret_cast<const unsigned char*>(
      k + base + size_t(piece_row) * dim + piece * 8);
  const unsigned char* v_from = reinterpret_cast<const unsigned char*>(
      v + base + size_t(piece_row) * dim + piece * 8);
  const size_t pass_bytes = size_t(kRowsPerPass) * dim * 2;
  const size_t tile_bytes = size_t(kKT) * dim * 2;
  int next_tile = 0, next_stage = 0;
  auto stage_kv = [&]() {
    if (next_tile < n_tiles) {
      unsigned char* dst = kv_s + next_stage * 2 * kKT * kPitch;
      if (!vec) {
        stage(dst, k, next_tile * kKT, kKT);
        stage(dst + kKT * kPitch, v, next_tile * kKT, kKT);
      } else if ((next_tile + 1) * kKT <= len && piece_valid) {
        unsigned char* to = dst + piece_row * kPitch + piece * 16;
        const unsigned char* kf = k_from;
        const unsigned char* vf = v_from;
#pragma unroll
        for (int r = 0; r < kKT; r += kRowsPerPass) {
          cp_async_16_or_zeros(to + r * kPitch, kf, true);
          cp_async_16_or_zeros(to + (kKT + r) * kPitch, vf, true);
          kf += pass_bytes;
          vf += pass_bytes;
        }
      } else {  // the last tile where it is partial, or a piece past D: zeros
        stage(dst, k, next_tile * kKT, kKT);
        stage(dst + kKT * kPitch, v, next_tile * kKT, kKT);
      }
      k_from += tile_bytes;
      v_from += tile_bytes;
      ++next_tile;
      next_stage = next_stage + 1 == S::kStages ? 0 : next_stage + 1;
    }
    cp_async_commit();  // an empty group past the end keeps the count in step
  };

  // the q tile joins the first group of copies as it is; each warp scales its
  // own rows in shared memory once they have landed
  if (vec) {
    static_assert(S::kRows % kRowsPerPass == 0, "whole passes");
    stage(q_s, q, row0, S::kRows);
  } else {
    for (int i = threadIdx.x; i < S::kRows * DP; i += kMmaThreads) {
      const int r = i / DP;
      const int d = i - r * DP;
      const bool valid = row0 + r < len && d < dim;
      reinterpret_cast<__nv_bfloat16*>(q_s + r * kPitch)[d] = __float2bfloat16(
          valid ? __bfloat162float(q[base + size_t(row0 + r) * dim + d]) * scale : 0.f);
    }
  }
#pragma unroll
  for (int t = 0; t < S::kStages - 1; ++t) stage_kv();

  // This lane's row addresses for ldmatrix. q (A, row-major): matrices (rows
  // 0-7, d 0-7), (rows 8-15, d 0-7), (rows 0-7, d 8-15), (rows 8-15, d 8-15).
  // k (B of q k^T, its rows are keys): (keys 0-7, d 0-7), (keys 0-7, d 8-15),
  // (keys 8-15, d 0-7), (keys 8-15, d 8-15): b0, b1 of two n8 tiles.
  // v (B of p v, transposed on load): (keys 0-7, d 0-7), (keys 8-15, d 0-7),
  // (keys 0-7, d 8-15), (keys 8-15, d 8-15): b0, b1 of two n8 tiles.
  const uint32_t q_lane = smem_addr(q_s) +
                          (warp * 16 * kMT + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
                          (lane >> 4) * 16;
  const uint32_t k_lane = ((lane & 7) + (lane >> 4) * 8) * kPitch + ((lane >> 3) & 1) * 16;
  const uint32_t v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * kPitch + (lane >> 4) * 16;

  float o[kMT][kND][4];
  float m_run[kMT][2], l_run[kMT][2];  // of fragment rows lane / 4 and lane / 4 + 8
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < kND; ++j) o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
  }

  uint32_t qf[S::kQInRegs ? kMT : 1][S::kQInRegs ? DP / 16 : 1][4];
  int this_stage = 0;
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<S::kStages - 2>();  // all but the newest copies have landed: tile t is here
    __syncthreads();  // ... for every thread (the first time, q too); tile t - 1 is read by none
    stage_kv();  // tile t + kStages - 1, into the stage tile t - 1 was in
    const uint32_t k_tile = smem_addr(kv_s + this_stage * 2 * kKT * kPitch);
    this_stage = this_stage + 1 == S::kStages ? 0 : this_stage + 1;
    const uint32_t v_tile = k_tile + kKT * kPitch;
    if (t == 0 && vec) {
      // q * scale rounded to bf16, as the plain version has it: the warp's own rows
      for (int i = lane; i < 16 * kMT * kPieces; i += 32) {
        uint4* at = reinterpret_cast<uint4*>(q_s + (warp * 16 * kMT + i / kPieces) * kPitch +
                                             (i % kPieces) * 16);
        const uint4 u = *at;
        *at = make_uint4(scale_bf16x2(u.x, scale), scale_bf16x2(u.y, scale),
                         scale_bf16x2(u.z, scale), scale_bf16x2(u.w, scale));
      }
      __syncwarp();
    }
    if constexpr (S::kQInRegs) {
      if (t == 0) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            ldmatrix_x4(qf[mt][kk], q_lane + mt * 16 * kPitch + kk * 32);
          }
        }
      }
    }

    float s[kMT][kNS][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int j = 0; j < kNS; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[kMT][4];
      if constexpr (!S::kQInRegs) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) ldmatrix_x4(a[mt], q_lane + mt * 16 * kPitch + kk * 32);
      }
#pragma unroll
      for (int jp = 0; jp < kNS / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, k_tile + k_lane + jp * 16 * kPitch + kk * 32);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if constexpr (S::kQInRegs) {
            mma_bf16(s[mt][2 * jp], qf[mt][kk], b[0], b[1]);
            mma_bf16(s[mt][2 * jp + 1], qf[mt][kk], b[2], b[3]);
          } else {
            mma_bf16(s[mt][2 * jp], a[mt], b[0], b[1]);
            mma_bf16(s[mt][2 * jp + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }

    // the online softmax on the fragments: e = 0, 1 are keys 8j + 2t, + 1 of
    // row lane / 4; e = 2, 3 the same keys of row lane / 4 + 8 (t = lane % 4)
    if ((t + 1) * kKT > len) {  // the last tile, where it is partial: keys past the end
      const int key0 = t * kKT + (lane % 4) * 2;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (key0 + 8 * j + (e & 1) >= len) s[mt][j][e] = -INFINITY;
          }
        }
      }
    }
    uint32_t p[kMT][kNS][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[mt][j][e]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(kFull, tile_max[h], 1));
        tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(kFull, tile_max[h], 2));
        const float m_new = fmaxf(m_run[mt][h], tile_max[h]);  // finite: a tile has a key < len
        // exp(x) = 2^(x log2 e): one multiply-add and one ex2 a score
        const float corr = ex2((m_run[mt][h] - m_new) * kLog2e);  // 0 on the first tile
        const float m_log2 = m_new * kLog2e;
        m_run[mt][h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          const float p0 = ex2(fmaf(s[mt][j][2 * h], kLog2e, -m_log2));
          const float p1 = ex2(fmaf(s[mt][j][2 * h + 1], kLog2e, -m_log2));
          sum += p0 + p1;
          p[mt][j][h] = pack_bf16(p0, p1);
        }
        l_run[mt][h] = l_run[mt][h] * corr + sum;  // this thread's keys; the quad is summed last
#pragma unroll
        for (int j = 0; j < kND; ++j) {
          o[mt][j][2 * h] *= corr;
          o[mt][j][2 * h + 1] *= corr;
        }
      }
    }

    // o += p v: the A fragment of keys 16 kk .. 16 kk + 15 is the packed
    // accumulators of score tiles 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kND / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_tile + v_lane + kk * 16 * kPitch + dp * 32);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const uint32_t a[4] = {p[mt][2 * kk][0], p[mt][2 * kk][1], p[mt][2 * kk + 1][0],
                                 p[mt][2 * kk + 1][1]};
          mma_bf16(o[mt][2 * dp], a, b[0], b[1]);
          mma_bf16(o[mt][2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // out = o / l through the warp's own rows of the q tile (no other warp reads them)
  __nv_bfloat16* o_s = reinterpret_cast<__nv_bfloat16*>(q_s);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[mt][h];
      l += __shfl_xor_sync(kFull, l, 1);
      l += __shfl_xor_sync(kFull, l, 2);
      const float inv = 1.f / l;
      const int r = warp * 16 * kMT + mt * 16 + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < kND; ++j) {
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(o_s) + r * kPitch +
                                     (8 * j + (lane % 4) * 2) * 2) =
            pack_bf16(o[mt][j][2 * h] * inv, o[mt][j][2 * h + 1] * inv);
      }
    }
  }
  __syncwarp();
  const int warp_row0 = warp * 16 * kMT;
  if (vec) {
    const int pieces = dim / 8;
    for (int i = lane; i < 16 * kMT * pieces; i += 32) {
      const int r = warp_row0 + i / pieces;
      const int piece = i % pieces;
      if (row0 + r < len) {
        *reinterpret_cast<uint4*>(out + base + size_t(row0 + r) * dim + piece * 8) =
            *reinterpret_cast<const uint4*>(q_s + r * kPitch + piece * 16);
      }
    }
  } else {
    for (int i = lane; i < 16 * kMT * dim; i += 32) {
      const int r = warp_row0 + i / dim;
      const int d = i % dim;
      if (row0 + r < len) {
        out[base + size_t(row0 + r) * dim + d] =
            reinterpret_cast<const __nv_bfloat16*>(q_s + r * kPitch)[d];
      }
    }
  }
}

template <int DP, int MT>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
               __nv_bfloat16* out, int64_t n, int len, int dim, float scale,
               cudaStream_t stream) {
  using S = MmaShape<DP, MT>;
  cudaError_t err = cudaFuncSetAttribute(axial_attention_mma_kernel<DP, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return int(err);
  const int64_t grid = n * ((len + S::kRows - 1) / S::kRows);
  if (grid > 0x7fffffff) return int(cudaErrorInvalidValue);
  axial_attention_mma_kernel<DP, MT><<<unsigned(grid), kMmaThreads, S::kSmem, stream>>>(q, k, v, out, len,
                                                                              dim, scale);
  return int(cudaGetLastError());
}

// Up to D = 64 a block takes 128 query rows (two m16 tiles a warp) where the
// axis has more than 64, else 64.
template <int DP>
int launch_mma_rows(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    __nv_bfloat16* out, int64_t n, int len, int dim, float scale,
                    cudaStream_t stream) {
  if (len > 64) return launch_mma<DP, 2>(q, k, v, out, n, len, dim, scale, stream);
  return launch_mma<DP, 1>(q, k, v, out, n, len, dim, scale, stream);
}

// ---------------------------------------------------------------------------
// "tile": float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTileRows = 64;      // query rows a block
constexpr int kTileKeys = 64;      // keys a staged tile
constexpr int kTileThreads = 256;  // 16 x 16: thread (ty, tx) owns query rows 4 ty .. 4 ty + 3
constexpr int kWeightPitch = kTileKeys + 4;  // floats a row of the staged softmax weights

// The tile shape at NJ chunks of 64 columns of D (1, 2 or 4: D padded to 64 NJ).
template <int NJ>
struct TileShape {
  static constexpr int kDP = 64 * NJ;
  // floats a staged row of q, k or v: a multiple of 4 whose quarter is odd, so
  // that the 16-byte reads of 8 lanes from 8 rows fall in different banks
  static constexpr int kPitch = kDP + 4;
  static constexpr int kSmem =
      ((kTileRows + 2 * kTileKeys) * kPitch + kTileRows * kWeightPitch) * int(sizeof(float));
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int NJ>
__global__ void __launch_bounds__(kTileThreads)
axial_attention_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out, int len,
                            int dim, float scale) {
  using S = TileShape<NJ>;
  constexpr int kDP = S::kDP, kPitch = S::kPitch;
  extern __shared__ uint4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kTileRows][kPitch], times scale
  float* k_s = q_s + kTileRows * kPitch;         // [kTileKeys][kPitch]
  float* v_s = k_s + kTileKeys * kPitch;         // [kTileKeys][kPitch]
  float* p_s = v_s + kTileKeys * kPitch;         // [kTileRows][kWeightPitch]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  // the blocks of one n are neighbours in the grid: k[n], v[n] come from L2
  const int row_tiles = (len + kTileRows - 1) / kTileRows;
  const size_t base = size_t(blockIdx.x / row_tiles) * len * dim;  // row n of q, k, v, out
  const int row0 = (blockIdx.x % row_tiles) * kTileRows;            // the block's first query row
  const bool vec = dim % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  const int d_end = (dim + 3) & ~3;  // the products stop at D, rounded up to the 16-byte reads

  // rows [first, first + 64) of src (row n) times `by` into dst, zeros past len and past dim
  auto stage = [&](float* dst, const float* src, int first, float by) {
    if (vec) {
      constexpr int kPieces = kDP / 4;  // 16-byte pieces a staged row
#pragma unroll 4
      for (int i = threadIdx.x; i < kTileRows * kPieces; i += kTileThreads) {
        const int r = i / kPieces;
        const int d = (i - r * kPieces) * 4;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        if (first + r < len && d < dim) {
          a = __ldg(reinterpret_cast<const float4*>(src + base + size_t(first + r) * dim + d));
          a = make_float4(a.x * by, a.y * by, a.z * by, a.w * by);
        }
        *reinterpret_cast<float4*>(dst + r * kPitch + d) = a;
      }
    } else {
#pragma unroll 4
      for (int i = threadIdx.x; i < kTileRows * kDP; i += kTileThreads) {
        const int r = i / kDP;
        const int d = i - r * kDP;
        const bool valid = first + r < len && d < dim;
        dst[r * kPitch + d] = valid ? src[base + size_t(first + r) * dim + d] * by : 0.f;
      }
    }
  };
  stage(q_s, q, row0, scale);  // rows past the end compute on zeros and are not stored

  float m_run[4], l_run[4];  // running max and sum of exp(score - max) of the thread's rows
  float acc[4][4 * NJ];      // their outputs at columns 64 jj + 4 tx .. + 3
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < len; k0 += kTileKeys) {
    __syncthreads();  // the previous tile has been read by every thread
    stage(k_s, k, k0, 1.f);
    stage(v_s, v, k0, 1.f);
    __syncthreads();  // (the first time, q too)

    // scores of rows 4 ty + i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    const float* q_t = q_s + 4 * ty * kPitch;
    const float* k_t = k_s + tx * kPitch;
#pragma unroll 2
    for (int d = 0; d < d_end; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(q_t + i * kPitch + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = *reinterpret_cast<const float4*>(k_t + 16 * j * kPitch + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
      }
    }

    // the online softmax: a row's 64 scores lie in the 16 threads of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= len) s[i][j] = -INFINITY;  // keys past the end
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], half_warp_max(tile_max));  // finite: key k0 < len
      const float corr = expf(m_run[i] - m_new);                     // 0 on the first tile
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(4 * ty + i) * kWeightPitch + tx + 16 * j] = p;
      }
      l_run[i] = l_run[i] * corr + half_warp_sum(sum);
#pragma unroll
      for (int c = 0; c < 4 * NJ; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row's weights are written and read by the same half-warp

    // acc += p v over the tile's keys (whole groups of 4: the weights past the end are zeros)
    const int keys = min(kTileKeys, (len - k0 + 3) & ~3);
    const float* p_t = p_s + 4 * ty * kWeightPitch;
    const float* v_t = v_s + 4 * tx;
#pragma unroll 2
    for (int kk = 0; kk < keys; kk += 4) {
      float pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(p_t + i * kWeightPitch + kk);
        pa[i][0] = a.x; pa[i][1] = a.y; pa[i][2] = a.z; pa[i][3] = a.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 vb = *reinterpret_cast<const float4*>(v_t + (kk + e) * kPitch + 64 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * jj + 0] = fmaf(pa[i][e], vb.x, acc[i][4 * jj + 0]);
            acc[i][4 * jj + 1] = fmaf(pa[i][e], vb.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(pa[i][e], vb.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(pa[i][e], vb.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row >= len) continue;
    float* o = out + base + size_t(row) * dim;
    const float inv = 1.f / l_run[i];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = 64 * jj + 4 * tx;
      if (vec) {
        if (col < dim) {
          *reinterpret_cast<float4*>(o + col) =
              make_float4(acc[i][4 * jj] * inv, acc[i][4 * jj + 1] * inv, acc[i][4 * jj + 2] * inv,
                          acc[i][4 * jj + 3] * inv);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (col + e < dim) o[col + e] = acc[i][4 * jj + e] * inv;
        }
      }
    }
  }
}

template <int NJ>
int launch_tile(const float* q, const float* k, const float* v, float* out, int64_t n, int len,
                int dim, float scale, cudaStream_t stream) {
  using S = TileShape<NJ>;
  cudaError_t err = cudaFuncSetAttribute(axial_attention_tile_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return int(err);
  const int64_t grid = n * ((len + kTileRows - 1) / kTileRows);
  if (grid > 0x7fffffff) return int(cudaErrorInvalidValue);
  axial_attention_tile_kernel<NJ><<<unsigned(grid), kTileThreads, S::kSmem, stream>>>(
      q, k, v, out, len, dim, scale);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the rule
// ---------------------------------------------------------------------------

constexpr int kRowsMaxL = 32;
constexpr int kRowsMaxD = 32;

bool in_domain(int64_t n, int len, int dim) {
  return n >= 1 && n <= 0x7fffffff && len >= 1 && len <= kMaxL && dim >= 1 && dim <= kMaxD;
}

template <typename T>
int launch_short(const T* q, const T* k, const T* v, T* out, int64_t n, int len, int dim,
                 float scale, cudaStream_t stream) {
  if (len <= 16) return launch_rows_d<T, 16>(q, k, v, out, n, len, dim, scale, stream);
  return launch_rows_d<T, 32>(q, k, v, out, n, len, dim, scale, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 on success); they launch on `stream` and do not
// synchronise.
extern "C" {

int satflow_axial_attention_f32(const void* q, const void* k, const void* v, void* out,
                                int64_t n, int len, int dim, float scale, int device,
                                void* stream) {
  if (!in_domain(n, len, dim)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  if (len <= kRowsMaxL && dim <= kRowsMaxD) {
    return launch_short<float>(qf, kf, vf, of, n, len, dim, scale, s);
  }
  if (dim <= 64) return launch_tile<1>(qf, kf, vf, of, n, len, dim, scale, s);
  if (dim <= 128) return launch_tile<2>(qf, kf, vf, of, n, len, dim, scale, s);
  return launch_tile<4>(qf, kf, vf, of, n, len, dim, scale, s);
}

int satflow_axial_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                 int64_t n, int len, int dim, float scale, int device,
                                 void* stream) {
  if (!in_domain(n, len, dim)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  if (len <= kRowsMaxL && dim <= kRowsMaxD) {
    return launch_short<__nv_bfloat16>(qb, kb, vb, ob, n, len, dim, scale, s);
  }
  if (dim <= 16) return launch_mma_rows<16>(qb, kb, vb, ob, n, len, dim, scale, s);
  if (dim <= 32) return launch_mma_rows<32>(qb, kb, vb, ob, n, len, dim, scale, s);
  if (dim <= 64) return launch_mma_rows<64>(qb, kb, vb, ob, n, len, dim, scale, s);
  if (dim <= 128) return launch_mma<128, 1>(qb, kb, vb, ob, n, len, dim, scale, s);
  return launch_mma<256, 1>(qb, kb, vb, ob, n, len, dim, scale, s);
}

const char* satflow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
