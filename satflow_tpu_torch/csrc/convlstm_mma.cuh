// The gate contraction of a ConvLSTM step on the bf16 tensor cores of NVIDIA
// Hopper (sm_90a), hand-written: mma.sync m16n8k16 with ldmatrix and cp.async
// in inline PTX. Used by the bfloat16 instantiations of the fused step (K1),
// its backward (K2), the halo-tensor step (K1h) and the channel-major step
// (K6a) through convlstm_gates.cuh; they differ only in where the window's
// pixels come from (convlstm_source.cuh).
//
//   gates = conv3x3_SAME(x, Wx) + conv3x3_SAME(h, Wh) + b
//
// bf16 operands, f32 accumulation, on unpadded NHWC tensors, weights in the
// JAX HWIO layout: Wx (3, 3, Cx, 4CH), Wh (3, 3, CH, 4CH), b (4CH), gate
// order i, f, o, g. It is an implicit GEMM per block: M = the tile's pixels,
// N = 4 x the block's hidden channels (all CH up to 128, else a group of 128
// of them, the groups on the grid's z axis), K = 9 taps x (Cx + CH, each padded
// to a multiple of 16).
//
// A operand. The block stages its tile's window (a one-pixel halo; 10 x 18
// pixels at CH <= 64, 6 x 18 above) of [x | h] once, as bf16: per pixel
// x's channels, zeros up to a multiple of 16, h's channels, zeros up to a
// multiple of 16, and 16 bytes of padding, so that the 8 rows of an ldmatrix
// (8 neighbouring pixels) fall on different banks. The zeros of SAME padding
// are written there too; the inner loop has no bounds checks. A tap (ky, kx)
// is then only a base offset into the window: the 16 rows of an A fragment are
// 16 neighbouring pixels of one window row.
//
// B operand. The weights need no repacking: HWIO rows w[tap][ci][0:4CH] are
// contiguous, and a group's four 128-column slices of them are too. K is
// walked in steps of 16 rows, tap by tap, x's rows then h's;
// kSlabSteps steps make a slab, which all 256 threads copy into shared memory
// with cp.async (rows padded by 16 bytes; rows of the zero padding are written
// as zeros), kStages slabs in a ring, so the copy of slab s + 2 runs under the
// products of slab s. B fragments come from ldmatrix.trans. All warps of the
// block share a slab.
//
// Warps. 8 warps split the block's M x N as Shape<CH> says. A warp owns whole
// tile rows (m16 tiles) and, for each block of 8 hidden channels it owns, the
// four n8 tiles at columns g * CH + [8j, 8j + 8), g = i, f, o, g. The m16n8
// accumulator fragment then holds all four gates of one (pixel, channel) in
// one thread, so the LSTM epilogue needs no exchange between threads.
//
//   CH    warps M x N   tile rows a warp   channels a warp   acc registers
//   8       8 x 1          1                  8                 16
//   16      8 x 1          1                 16                 32
//   32      4 x 2          2                 16                 64
//   64      2 x 4          4                 16                128
//   128     1 x 8          4 (of 4)          16                128
//   256     as 128, for the block's group of 128 channels
//
// What bounds it. A k16 step of a 64 x 64 warp tile is 32 mma for 2 KB of A
// and 2 KB of B fragments read from shared memory, which delivers 128 bytes a
// clock to the SM's four tensor cores: the fragment loads, not the tensor
// cores, set the pace, near half of the 989 TFLOP/s peak at best. wgmma, which
// reads B (and A) straight from shared memory for a 64-row tile, is what lifts
// that; it is left for a later change, as is a persistent block that stages
// the next tile's window under this tile's products (the window is staged with
// plain loads before the first product, one block per SM, so it is exposed).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "convlstm_tile.cuh"

namespace convlstm_mma {

using convlstm_tile::block_ch;
using convlstm_tile::kHaloW;
using convlstm_tile::kThreads;
using convlstm_tile::kTileW;
using convlstm_tile::Tile;
using convlstm_tile::tile_rows;

template <int CH>
struct Shape {
  static_assert(CH == 8 || CH == 16 || CH == 32 || CH == 64 || CH == 128 || CH == 256,
                "hidden widths the contraction is written for");
  static constexpr int kBlockCh = block_ch<CH>();          // hidden channels a block owns
  static constexpr int kN = 4 * kBlockCh;                  // the block's gate columns
  static constexpr int kChp = (CH + 15) / 16 * 16;         // h's channels as staged
  static constexpr int kWarpCh = kBlockCh < 16 ? kBlockCh : 16;  // hidden channels a warp owns
  static constexpr int kJ = kWarpCh / 8;                   // blocks of 8 channels a warp owns
  static constexpr int kWarpsN = kBlockCh / kWarpCh;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kRows = tile_rows<CH>() / kWarpsM;  // tile rows (m16 tiles) a warp owns
  static constexpr int kSlabSteps = kBlockCh > 64 ? 2 : 4; // k16 steps a weight slab
  static constexpr int kSlabPitch = kN * 2 + 16;           // bytes a staged weight row
  static constexpr int kSlabBytes = kSlabSteps * 16 * kSlabPitch;
  static constexpr int kStages = 3;
  static_assert(kWarpsM * kWarpsN == 8 && kRows * kWarpsM == tile_rows<CH>(), "8 warps");
};

__host__ __device__ inline int round_up_16(int n) { return (n + 15) & ~15; }

// Bytes a staged pixel: [x | zeros | h | zeros] as bf16, and 16 bytes of padding.
template <int CH>
__host__ __device__ inline int pixel_pitch(int cx) {
  return (round_up_16(cx) + Shape<CH>::kChp) * 2 + 16;
}

template <int CH>
inline int smem_bytes(int cx) {
  return (tile_rows<CH>() + 2) * kHaloW * pixel_pitch<CH>(cx) +
         Shape<CH>::kStages * Shape<CH>::kSlabBytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// The same, or 16 bytes of zeros where !valid (src is then not read).
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

// The accumulators of one thread: acc[r][j][g][e] is gate g of the warp's tile
// row r, 8-channel block j; e as the m16n8 fragment lays it out (see
// for_each_pair).
template <int CH>
using Acc = float[Shape<CH>::kRows][Shape<CH>::kJ][4][4];

// The gate pre-activations of the block's tile: `src` stages the window of its
// image at (tile.y0, tile.x0) (see convlstm_source.cuh), which is contracted
// against the tile's group of gate columns. `smem` is the block's dynamic
// shared memory, smem_bytes<CH>(cx) long and 16-byte aligned. wx and wh are
// 16-byte aligned. Every thread of the block must call it.
template <int CH, typename Src>
__device__ __forceinline__ void gate_preactivations(
    Acc<CH>& acc, unsigned char* __restrict__ smem, const Src& src,
    const __nv_bfloat16* __restrict__ wx, const __nv_bfloat16* __restrict__ wh,
    const __nv_bfloat16* __restrict__ bias, const Tile& tile, int cx) {
  using S = Shape<CH>;
  constexpr int kWindowRows = tile_rows<CH>() + 2;
  const int cxp = round_up_16(cx);
  const int kt = cxp + S::kChp;              // K rows a tap
  const int col0 = tile.group * S::kBlockCh; // the group's first column of each gate
  // k16 steps in all, 9 * kt / 16, rounded up to whole slabs: the steps past
  // the end get zero weights
  const int n_slabs = (9 * (kt / 16) + S::kSlabSteps - 1) / S::kSlabSteps;
  const int pitch = kt * 2 + 16;
  unsigned char* window = smem;
  unsigned char* slabs = smem + kWindowRows * kHaloW * pitch;

  // Where a walk over the k16 steps stands: rows k .. k + 15 of tap's
  // [x | 0 | h | 0]; tap 9 is past the end.
  struct Walk {
    int tap = 0, k = 0;
    __device__ __forceinline__ void next(int kt) {
      k += 16;
      if (k == kt) {
        k = 0;
        ++tap;
      }
    }
  };
  Walk copied, multiplied;

  // Copy the next slab of the weights into stage `stage`: kSlabSteps k16
  // steps of 16 rows, the group's 4 x kBlockCh bf16 a row, as 16-byte pieces.
  auto load_slab = [&](int stage) {
    unsigned char* slab = slabs + stage * S::kSlabBytes;
    constexpr int kPieces = S::kN * 2 / 16;  // 16-byte pieces a row
#pragma unroll
    for (int q = 0; q < S::kSlabSteps; ++q) {
#pragma unroll
      for (int it = 0; it < (16 * kPieces + kThreads - 1) / kThreads; ++it) {
        const int i = it * kThreads + threadIdx.x;
        if (i >= 16 * kPieces) break;
        const int r = i / kPieces;
        const int piece = i % kPieces;
        const int k = copied.k + r;
        // slab column piece * 8 is gate g's column c of the group
        const int g = piece * 8 / S::kBlockCh;
        const int col = g * CH + col0 + piece * 8 % S::kBlockCh;
        const __nv_bfloat16* w = nullptr;
        if (copied.tap < 9) {
          if (k < cx) {
            w = wx + (size_t(copied.tap) * cx + k) * (4 * CH);
          } else if (k >= cxp && k - cxp < CH) {
            w = wh + (size_t(copied.tap) * CH + (k - cxp)) * (4 * CH);
          }
        }
        unsigned char* dst = slab + (q * 16 + r) * S::kSlabPitch + piece * 16;
        if (w != nullptr) {
          cp_async_16(dst, w + col);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      copied.next(kt);
    }
    cp_async_commit();
  };

  // Stage the window: per pixel [x | zeros | h | zeros] as bf16, zeros where
  // SAME padding puts them; copied asynchronously or stored (the first group;
  // the slabs follow it, and the first wait and __syncthreads() below cover
  // both kinds of write).
  src.template stage_bf16<CH>(window, pitch, kt, cxp, kWindowRows, tile.y0, tile.x0);
  cp_async_commit();
  load_slab(0);
  load_slab(1);  // n_slabs >= 5: 9 taps of at least 2 steps

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp / S::kWarpsN;
  const int wn = warp % S::kWarpsN;

  // acc = bias: e = 0, 2 are channel 2t, e = 1, 3 channel 2t + 1 (t = lane % 4)
#pragma unroll
  for (int j = 0; j < S::kJ; ++j) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int col = g * CH + col0 + wn * S::kWarpCh + j * 8 + (lane % 4) * 2;
      const float b0 = __bfloat162float(bias[col]);
      const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
      for (int r = 0; r < S::kRows; ++r) {
        acc[r][j][g][0] = acc[r][j][g][2] = b0;
        acc[r][j][g][1] = acc[r][j][g][3] = b1;
      }
    }
  }

  // This lane's row addresses for ldmatrix. A: matrices (pixels 0-7, k 0-7),
  // (pixels 8-15, k 0-7), (pixels 0-7, k 8-15), (pixels 8-15, k 8-15) of the
  // warp's first tile row at tap (0, 0). B: matrices (k 0-7, gate g), (k 8-15,
  // gate g), (k 0-7, gate g + 1), (k 8-15, gate g + 1) of 8-channel block 0.
  const uint32_t a_lane = smem_addr(window) +
                          ((wm * S::kRows) * kHaloW + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch +
                          (lane >> 4) * 16;
  const uint32_t b_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * S::kSlabPitch +
                          ((lane >> 4) * S::kBlockCh + wn * S::kWarpCh) * 2;

  // The fragments of the step in hand and of the next one: each ldmatrix is
  // started one row of products ahead of its use.
  uint32_t bf[2][S::kJ][2][4];
  uint32_t af[2][4];
  auto a_address = [&]() {
    // a step past the end multiplies tap 8's first rows by zero weights
    const int tap = min(multiplied.tap, 8);
    const int k0 = multiplied.tap < 9 ? multiplied.k : 0;
    return a_lane + ((tap / 3) * kHaloW + tap % 3) * pitch + k0 * 2;
  };

#pragma unroll 1
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait<1>();  // all but the newest copy have landed: slab s is here
    __syncthreads();     // ... for every thread; and slab s - 1 is read by none
    if (s + 2 < n_slabs) {
      load_slab((s + 2) % S::kStages);  // into the stage slab s - 1 was in
    } else {
      cp_async_commit();  // keeps the count of groups in step with s
    }
    const uint32_t slab = smem_addr(slabs + (s % S::kStages) * S::kSlabBytes) + b_lane;
    auto load_b = [&](int q) {
#pragma unroll
      for (int j = 0; j < S::kJ; ++j) {
#pragma unroll
        for (int gp = 0; gp < 2; ++gp) {
          ldmatrix_x4_trans(bf[q % 2][j][gp],
                            slab + q * 16 * S::kSlabPitch + (gp * 2 * S::kBlockCh + j * 8) * 2);
        }
      }
    };
    uint32_t a_step = a_address();
    load_b(0);
    ldmatrix_x4(af[0], a_step);
#pragma unroll
    for (int q = 0; q < S::kSlabSteps; ++q) {
      if (q + 1 < S::kSlabSteps) load_b(q + 1);
      multiplied.next(kt);
      const uint32_t a_next = a_address();
#pragma unroll
      for (int r = 0; r < S::kRows; ++r) {
        const int n = q * S::kRows + r;  // this row's fragment is af[n % 2]
        if (r + 1 < S::kRows) {
          ldmatrix_x4(af[(n + 1) % 2], a_step + (r + 1) * kHaloW * pitch);
        } else if (q + 1 < S::kSlabSteps) {
          ldmatrix_x4(af[(n + 1) % 2], a_next);
        }
#pragma unroll
        for (int j = 0; j < S::kJ; ++j) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            mma_bf16(acc[r][j][g], af[n % 2], bf[q % 2][j][g / 2][(g % 2) * 2],
                     bf[q % 2][j][g / 2][(g % 2) * 2 + 1]);
          }
        }
      }
      a_step = a_next;
    }
  }
  cp_async_wait<0>();
}

// Calls f(row, col, channel, gi, gf, go, gg) for every pair of adjacent hidden
// channels (channel, channel + 1) the thread owns: row and col are the pixel's
// offsets in the tile, channel counts within the block's group, and each gate
// is a float2 over the two channels.
template <int CH, typename F>
__device__ __forceinline__ void for_each_pair(const Acc<CH>& acc, F&& f) {
  using S = Shape<CH>;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp / S::kWarpsN;
  const int wn = warp % S::kWarpsN;
#pragma unroll
  for (int r = 0; r < S::kRows; ++r) {
#pragma unroll
    for (int j = 0; j < S::kJ; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // fragment rows lane / 4 and lane / 4 + 8
        const int e = half * 2;
        f(wm * S::kRows + r, lane / 4 + half * 8, wn * S::kWarpCh + j * 8 + (lane % 4) * 2,
          make_float2(acc[r][j][0][e], acc[r][j][0][e + 1]),
          make_float2(acc[r][j][1][e], acc[r][j][1][e + 1]),
          make_float2(acc[r][j][2][e], acc[r][j][2][e + 1]),
          make_float2(acc[r][j][3][e], acc[r][j][3][e + 1]));
      }
    }
  }
}

}  // namespace convlstm_mma
