// The gate contraction of a ConvLSTM step on the tensor cores of NVIDIA
// Hopper (sm_90a), hand-written: mma.sync with ldmatrix and cp.async in inline
// PTX, in two element types:
//
//   Bf16  mma.sync m16n8k16 bf16 x bf16 -> f32: the bfloat16 instantiations of
//         the fused step (K1), its backward (K2), the halo-tensor step (K1h),
//         the channel-major step (K6a), the pad-row prototype step (T3) and the
//         W-padded study steps (T1, T2 and their yardstick K1p)
//   S8    mma.sync m16n8k32 s8 x s8 -> s32: the int8 step (K5), whose sums are
//         exact
//
//   gates = conv3x3_SAME(x, Wx) + conv3x3_SAME(h, Wh) [+ b]
//
// The kernels differ in where the window's pixels come from
// (convlstm_source.cuh) and in how the weights are laid out (below).
//
// It is an implicit GEMM per block: M = the tile's pixels, N = 4 x the
// block's hidden channels (all CH up to 128, else a group of 128 of them, the
// groups on the grid's z axis), K = 9 taps x [x | h]. Everything is counted in
// bytes, and a k step is 32 bytes of K: 16 bf16 channels or 32 int8 ones. The
// A fragment of m16n8k32.s8 (16 rows x 32 bytes) is byte for byte the one of
// m16n8k16.bf16 (16 rows x 16 bf16), and so is the B fragment (8 columns x 32
// bytes: thread t holds bytes 4 (t % 4) .. 4 (t % 4) + 3 of column t / 4 in
// b0, and the same 16 bytes on in b1), as are the accumulators' (row, column)
// maps (f32 or s32). So one set of ldmatrix addresses serves both types.
//
// A operand. The block stages its tile's window (a one-pixel halo; 10 x 18
// pixels at CH <= 64, 6 x 18 above) of [x | h] once: per pixel x's channels,
// zeros up to a multiple of 32 bytes, h's channels, zeros up to a multiple of
// 32 bytes, and 16 bytes of padding, so that the 8 rows of an ldmatrix (8
// neighbouring pixels) fall on different banks. The zeros of SAME padding are
// written there too; the inner loop has no bounds checks. A tap (ky, kx) is
// then only a base offset into the window: the 16 rows of an A fragment are
// 16 neighbouring pixels of one window row.
//
// B operand. K is walked in k steps, by default tap by tap, x's bytes then
// h's (Walk); RowWalk walks the JAX main kernel's order instead (per kernel
// row, x's three taps, then h's three). kSlabSteps steps make a slab, which
// all 256 threads copy into shared memory with cp.async (rows of the zero
// padding are written as zeros), kStages slabs in a ring, so the copy of slab
// s + 2 runs under the products of slab s. All warps of the block share a
// slab. Three layouts of the weights:
//
//   HwioWeights    bf16 Wx (3, 3, Cx, 4CH), Wh (3, 3, CH, 4CH) as JAX lays
//                  them out: rows w[tap][ci][0:4CH] are contiguous, so a slab
//                  is 16 rows a k step of the group's 4 x kBlockCh columns
//                  ([k][n]), read with ldmatrix.trans. K1, K2, K1h, K6a.
//   StridedWeights bf16 rows of 4CH gate columns, as HwioWeights, but one
//                  tensor whose row of x's (h's) channel k at tap (ky, kx) is
//                  base + ky sy + kx sx + k, a (base, sy, sx) for each of x
//                  and h: the study steps' w9 (9, Cx+Ch, 4CH) and w3 (3,
//                  3Cx+3CH, 4CH) read as given. T1, T2, K1p.
//   KMajorWeights  w (9, 4CH, row bytes): each column's weights of a tap
//                  contiguous along K (x's, then h's). A slab is the group's
//                  4 x kBlockCh columns of kSlabSteps x 32 bytes ([n][k],
//                  rows padded by 16 bytes), read with a plain ldmatrix, whose
//                  8x8 b16 matrices hand thread t the 4 bytes 4 (t % 4) of row
//                  t / 4: the B fragment of either type. ldmatrix.trans moves
//                  16-bit elements only, so this is the one layout the int8
//                  operand can take. K5 (int8, packed once a session) and T3
//                  (its w9 (9, 4C, 2C) as given).
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
// What bounds it. A k step of a 64 x 64 warp tile is 32 mma for 2 KB of A
// and 2 KB of B fragments read from shared memory, which delivers 128 bytes a
// clock to the SM's four tensor cores: the fragment loads, not the tensor
// cores, set the pace, near half of the bf16 peak (989 TFLOP/s) at best; an
// s8 k step moves the same bytes for twice the multiply-adds. wgmma, which
// reads B (and A) straight from shared memory for a 64-row tile, is what lifts
// that; it is left for a later change, as is a persistent block that stages
// the next tile's window under this tile's products (the window is staged with
// plain loads before the first product, one block per SM, so it is exposed).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "convlstm_tile.cuh"

namespace convlstm_mma {

using convlstm_tile::block_ch;
using convlstm_tile::kHaloW;
using convlstm_tile::kThreads;
using convlstm_tile::kTileW;
using convlstm_tile::Tile;
using convlstm_tile::tile_rows;

constexpr int kStepBytes = 32;  // bytes of K a k step: 16 bf16 or 32 int8 channels

template <int CH>
struct Shape {
  static_assert(CH == 8 || CH == 16 || CH == 32 || CH == 64 || CH == 128 || CH == 256,
                "hidden widths the contraction is written for");
  static constexpr int kBlockCh = block_ch<CH>();          // hidden channels a block owns
  static constexpr int kN = 4 * kBlockCh;                  // the block's gate columns
  static constexpr int kWarpCh = kBlockCh < 16 ? kBlockCh : 16;  // hidden channels a warp owns
  static constexpr int kJ = kWarpCh / 8;                   // blocks of 8 channels a warp owns
  static constexpr int kWarpsN = kBlockCh / kWarpCh;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kRows = tile_rows<CH>() / kWarpsM;  // tile rows (m16 tiles) a warp owns
  static constexpr int kSlabSteps = kBlockCh > 64 ? 2 : 4; // k steps a weight slab
  static constexpr int kStages = 3;
  static_assert(kWarpsM * kWarpsN == 8 && kRows * kWarpsM == tile_rows<CH>(), "8 warps");
};

__host__ __device__ inline int round_up_16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int round_up_32(int n) { return (n + 31) & ~31; }

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

// d += a (16 x 32, row-major) * b (32 x 8, column-major), s8 products summed
// exactly in s32 (no .satfinite: the callers' sums stay far inside 2^31).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two element types: the staged element's size and the accumulator's
// type (mma_bf16 or mma_s8 makes a k step's products).
struct Bf16 {
  using Value = float;
  static constexpr int kBytes = 2;
};
struct S8 {
  using Value = int;
  static constexpr int kBytes = 1;
};

// Bytes a staged pixel: [x | zeros | h | zeros], each part a multiple of 32
// bytes, and 16 bytes of padding.
template <int CH, typename M = Bf16>
__host__ __device__ inline int pixel_pitch(int cx) {
  return round_up_32(cx * M::kBytes) + round_up_32(CH * M::kBytes) + 16;
}

// Where a walk over the k steps stands: bytes k .. k + 31 of tap's [x | 0 |
// h | 0] (kt bytes a tap); tap 9 is past the end.
struct Walk {
  int tap = 0, k = 0;
  __device__ __forceinline__ void next(int kt) {
    k += kStepBytes;
    if (k == kt) {
      k = 0;
      ++tap;
    }
  }
};

// The same pair in the JAX main kernel's order (fused_convlstm_step.py's
// im2col): for each kernel row ky, x's k steps of taps (ky, 0), (ky, 1), (ky,
// 2), then h's of the same three taps. x's bytes of a tap are kt less h's,
// round_up_32(CH * M::kBytes); tap 9 is past the end.
template <int CH, typename M = Bf16>
struct RowWalk {
  int tap = 0, k = 0;
  __device__ __forceinline__ void next(int kt) {
    const int cxp = kt - round_up_32(CH * M::kBytes);
    k += kStepBytes;
    if (k == cxp) {  // x's part of the tap is done: x's next tap, or h's first of the row
      if (tap % 3 < 2) {
        ++tap;
        k = 0;
      } else {
        tap -= 2;
      }
    } else if (k == kt) {  // h's part is done: h's next tap, or x's first of the next row
      ++tap;
      k = tap % 3 == 0 ? 0 : cxp;
    }
  }
};

// B from HWIO bf16 weights (see the top of the file): a slab is kSlabSteps x
// 16 rows (k) of the group's kN columns, rows padded by 16 bytes.
template <int CH>
struct HwioWeights {
  using S = Shape<CH>;
  static constexpr int kPitch = S::kN * 2 + 16;  // bytes a staged row
  static constexpr int kSlabBytes = S::kSlabSteps * 16 * kPitch;
  const __nv_bfloat16* wx;
  const __nv_bfloat16* wh;

  // Copy the slab at `copied` (advanced past it): 16-byte pieces of the rows
  // k of [x | 0 | h | 0], cx x channels padded to cxp bytes, the group's
  // columns from col0 on in each gate.
  __device__ __forceinline__ void load_slab(unsigned char* slab, Walk& copied, int kt, int cx,
                                            int cxp, int col0) const {
    constexpr int kPieces = S::kN * 2 / 16;  // 16-byte pieces a row
#pragma unroll
    for (int q = 0; q < S::kSlabSteps; ++q) {
#pragma unroll
      for (int it = 0; it < (16 * kPieces + kThreads - 1) / kThreads; ++it) {
        const int i = it * kThreads + threadIdx.x;
        if (i >= 16 * kPieces) break;
        const int r = i / kPieces;
        const int piece = i % kPieces;
        const int k = copied.k / 2 + r;  // the row's channel of [x | 0 | h | 0]
        // slab column piece * 8 is gate g's column c of the group
        const int g = piece * 8 / S::kBlockCh;
        const int col = g * CH + col0 + piece * 8 % S::kBlockCh;
        const __nv_bfloat16* w = nullptr;
        if (copied.tap < 9) {
          if (k < cx) {
            w = wx + (size_t(copied.tap) * cx + k) * (4 * CH);
          } else if (k >= cxp / 2 && k - cxp / 2 < CH) {
            w = wh + (size_t(copied.tap) * CH + (k - cxp / 2)) * (4 * CH);
          }
        }
        unsigned char* dst = slab + (q * 16 + r) * kPitch + piece * 16;
        if (w != nullptr) {
          cp_async_16(dst, w + col);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      copied.next(kt);
    }
  }
  // This lane's ldmatrix row address in a slab: matrices (k 0-7, gate g),
  // (k 8-15, gate g), (k 0-7, gate g + 1), (k 8-15, gate g + 1) of 8-channel
  // block 0 of the warp's channels.
  __device__ static uint32_t lane_offset(int lane, int wn) {
    return ((lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
           ((lane >> 4) * S::kBlockCh + wn * S::kWarpCh) * 2;
  }
  // ... and the offset of k step q, 8-channel block j, gate pair gp from there
  __device__ static uint32_t offset(int q, int j, int gp) {
    return q * 16 * kPitch + (gp * 2 * S::kBlockCh + j * 8) * 2;
  }
  __device__ static void load(uint32_t (&r)[4], uint32_t addr) { ldmatrix_x4_trans(r, addr); }
};

// Where StridedWeights finds a part's rows: the row of channel k at tap (ky,
// kx) is base + ky * sy + kx * sx + k.
struct RowStrides {
  int base, sy, sx;
};

// B from one bf16 tensor of rows of 4CH gate columns found by strides (see
// the top of the file); the slab, the fragments and their loads are
// HwioWeights'. load_slab takes either walk.
template <int CH>
struct StridedWeights {
  using S = Shape<CH>;
  using Hwio = HwioWeights<CH>;
  static constexpr int kPitch = Hwio::kPitch;
  static constexpr int kSlabBytes = Hwio::kSlabBytes;
  const __nv_bfloat16* w;
  RowStrides x, h;

  template <typename W>
  __device__ __forceinline__ void load_slab(unsigned char* slab, W& copied, int kt, int cx,
                                            int cxp, int col0) const {
    constexpr int kPieces = S::kN * 2 / 16;  // 16-byte pieces a row
#pragma unroll
    for (int q = 0; q < S::kSlabSteps; ++q) {
      const int ky = copied.tap / 3;
      const int kx = copied.tap % 3;
#pragma unroll
      for (int it = 0; it < (16 * kPieces + kThreads - 1) / kThreads; ++it) {
        const int i = it * kThreads + threadIdx.x;
        if (i >= 16 * kPieces) break;
        const int r = i / kPieces;
        const int piece = i % kPieces;
        const int k = copied.k / 2 + r;  // the row's channel of [x | 0 | h | 0]
        // slab column piece * 8 is gate g's column c of the group
        const int g = piece * 8 / S::kBlockCh;
        const int col = g * CH + col0 + piece * 8 % S::kBlockCh;
        int row = -1;
        if (copied.tap < 9) {
          if (k < cx) {
            row = x.base + ky * x.sy + kx * x.sx + k;
          } else if (k >= cxp / 2 && k - cxp / 2 < CH) {
            row = h.base + ky * h.sy + kx * h.sx + (k - cxp / 2);
          }
        }
        unsigned char* dst = slab + (q * 16 + r) * kPitch + piece * 16;
        if (row >= 0) {
          cp_async_16(dst, w + size_t(row) * (4 * CH) + col);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      copied.next(kt);
    }
  }
  __device__ static uint32_t lane_offset(int lane, int wn) { return Hwio::lane_offset(lane, wn); }
  __device__ static uint32_t offset(int q, int j, int gp) { return Hwio::offset(q, j, gp); }
  __device__ static void load(uint32_t (&r)[4], uint32_t addr) { Hwio::load(r, addr); }
};

// B from K-major weights (see the top of the file): w holds, for tap t and
// gate column n (of all 4CH), row_bytes bytes at (t * 4CH + n) * row_bytes:
// x's x_bytes, then h's h_bytes (x_bytes, h_bytes and row_bytes multiples of
// 16, w 16-byte aligned). A slab is the group's kN columns of kSlabSteps k
// steps, a column padded by 16 bytes.
template <int CH>
struct KMajorWeights {
  using S = Shape<CH>;
  static constexpr int kPitch = S::kSlabSteps * kStepBytes + 16;  // bytes a staged column
  static constexpr int kSlabBytes = S::kN * kPitch;
  static constexpr int kPieces = S::kSlabSteps * kStepBytes / 16;  // 16-byte pieces a column
  static_assert(kThreads % kPieces == 0 && S::kN * kPieces % kThreads == 0,
                "a thread copies the same piece of its columns in every slab");
  const unsigned char* w;
  int row_bytes, x_bytes, h_bytes;

  // Copy the slab at `copied` (advanced past it). Thread i copies piece i %
  // kPieces of every (kThreads / kPieces)-th column: its k step is the same
  // in every slab, so only that step's place in the walk is found anew.
  __device__ __forceinline__ void load_slab(unsigned char* slab, Walk& copied, int kt, int cx,
                                            int cxp, int col0) const {
    const int piece = threadIdx.x % kPieces;
    Walk at = copied;
#pragma unroll
    for (int q = 0; q < S::kSlabSteps; ++q) {
      if (q < piece / 2) at.next(kt);
      copied.next(kt);
    }
    // the piece's bytes in a column's row of the tap, or -1 for zeros
    const int k = at.k + (piece % 2) * 16;
    int kk = -1;
    if (at.tap < 9) {
      if (k < x_bytes) {
        kk = k;
      } else if (k >= cxp && k - cxp < h_bytes) {
        kk = x_bytes + (k - cxp);
      }
    }
    const unsigned char* src = w + size_t(at.tap) * (4 * CH) * row_bytes + kk;
#pragma unroll
    for (int it = 0; it < S::kN * kPieces / kThreads; ++it) {
      const int n = (it * kThreads + threadIdx.x) / kPieces;  // the slab's column
      // slab column n is gate g's column c of the group
      const int col = n / S::kBlockCh * CH + col0 + n % S::kBlockCh;
      unsigned char* dst = slab + n * kPitch + piece * 16;
      if (kk >= 0) {
        cp_async_16(dst, src + size_t(col) * row_bytes);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  // This lane's ldmatrix row address in a slab: matrices (gate g, bytes
  // 0-15), (gate g, bytes 16-31), (gate g + 1, bytes 0-15), (gate g + 1,
  // bytes 16-31) of the warp's first 8 channels, a row per column.
  __device__ static uint32_t lane_offset(int lane, int wn) {
    return ((lane & 7) + (lane >> 4) * S::kBlockCh + wn * S::kWarpCh) * kPitch +
           ((lane >> 3) & 1) * 16;
  }
  // ... and the offset of k step q, 8-channel block j, gate pair gp from there
  __device__ static uint32_t offset(int q, int j, int gp) {
    return (gp * 2 * S::kBlockCh + j * 8) * kPitch + q * kStepBytes;
  }
  __device__ static void load(uint32_t (&r)[4], uint32_t addr) { ldmatrix_x4(r, addr); }
};

template <int CH, typename M = Bf16, typename Wts = HwioWeights<CH>>
inline int smem_bytes(int cx) {
  return (tile_rows<CH>() + 2) * kHaloW * pixel_pitch<CH, M>(cx) +
         Shape<CH>::kStages * Wts::kSlabBytes;
}

// The accumulators of one thread: acc[r][j][g][e] is gate g of the warp's tile
// row r, 8-channel block j; e as the m16n8 fragment lays it out (see
// for_each_pair). V: float (Bf16) or int (S8).
template <int CH, typename V = float>
using Acc = V[Shape<CH>::kRows][Shape<CH>::kJ][4][4];

// The gate pre-activations of the block's tile in element type M: `src`
// stages the window of its image at (tile.y0, tile.x0) (see
// convlstm_source.cuh), which is contracted against the tile's group of gate
// columns of `wts` (HwioWeights, KMajorWeights or StridedWeights), the k
// steps in the order of W (Walk, or RowWalk with StridedWeights). With M =
// Bf16 the sums start from bias (bf16, 4CH); with S8 from zero (bias is not
// read). `smem` is the block's dynamic shared memory, smem_bytes<CH, M,
// Wts>(cx) long and 16-byte aligned. Every thread of the block must call it.
template <int CH, typename M, typename W = Walk, typename Src, typename Wts>
__device__ __forceinline__ void gate_preactivations(
    Acc<CH, typename M::Value>& acc, unsigned char* __restrict__ smem, const Src& src,
    const Wts& wts, const __nv_bfloat16* __restrict__ bias, const Tile& tile, int cx) {
  using S = Shape<CH>;
  using V = typename M::Value;
  constexpr int kWindowRows = tile_rows<CH>() + 2;
  const int cxp = round_up_32(cx * M::kBytes);         // x's bytes as staged
  const int kt = cxp + round_up_32(CH * M::kBytes);    // K bytes a tap
  const int col0 = tile.group * S::kBlockCh;  // the group's first column of each gate
  // k steps in all, 9 * kt / 32, rounded up to whole slabs: the steps past
  // the end get zero weights
  const int n_slabs = (9 * (kt / kStepBytes) + S::kSlabSteps - 1) / S::kSlabSteps;
  const int pitch = kt + 16;
  unsigned char* window = smem;
  unsigned char* slabs = smem + kWindowRows * kHaloW * pitch;
  W copied, multiplied;

  auto load_slab = [&](int stage) {
    wts.load_slab(slabs + stage * Wts::kSlabBytes, copied, kt, cx, cxp, col0);
    cp_async_commit();
  };

  // Stage the window: per pixel [x | zeros | h | zeros], zeros where SAME
  // padding puts them; copied asynchronously or stored (the first group; the
  // slabs follow it, and the first wait and __syncthreads() below cover both
  // kinds of write).
  if constexpr (std::is_same<M, S8>::value) {
    src.template stage_s8<CH>(window, pitch, kt, cxp, kWindowRows, tile.y0, tile.x0);
  } else {
    src.template stage_bf16<CH>(window, pitch, kt / 2, cxp / 2, kWindowRows, tile.y0, tile.x0);
  }
  cp_async_commit();
  load_slab(0);
  load_slab(1);  // n_slabs >= 5: 9 taps of at least 2 steps

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp / S::kWarpsN;
  const int wn = warp % S::kWarpsN;

  // acc = bias (Bf16) or 0 (S8): e = 0, 2 are channel 2t, e = 1, 3 channel
  // 2t + 1 (t = lane % 4)
#pragma unroll
  for (int j = 0; j < S::kJ; ++j) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      V b0 = 0, b1 = 0;
      if constexpr (std::is_same<V, float>::value) {
        const int col = g * CH + col0 + wn * S::kWarpCh + j * 8 + (lane % 4) * 2;
        b0 = __bfloat162float(bias[col]);
        b1 = __bfloat162float(bias[col + 1]);
      }
#pragma unroll
      for (int r = 0; r < S::kRows; ++r) {
        acc[r][j][g][0] = acc[r][j][g][2] = b0;
        acc[r][j][g][1] = acc[r][j][g][3] = b1;
      }
    }
  }

  // This lane's row addresses for ldmatrix. A: matrices (pixels 0-7, bytes
  // 0-15), (pixels 8-15, bytes 0-15), (pixels 0-7, bytes 16-31), (pixels 8-15,
  // bytes 16-31) of the warp's first tile row at tap (0, 0). B: see the
  // weights' lane_offset.
  const uint32_t a_lane = smem_addr(window) +
                          ((wm * S::kRows) * kHaloW + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch +
                          (lane >> 4) * 16;
  const uint32_t b_lane = Wts::lane_offset(lane, wn);

  // The fragments of the step in hand and of the next one: each ldmatrix is
  // started one row of products ahead of its use.
  uint32_t bf[2][S::kJ][2][4];
  uint32_t af[2][4];
  auto a_address = [&]() {
    // a step past the end multiplies tap 8's first bytes by zero weights
    const int tap = min(multiplied.tap, 8);
    const int k0 = multiplied.tap < 9 ? multiplied.k : 0;
    return a_lane + ((tap / 3) * kHaloW + tap % 3) * pitch + k0;
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
    const uint32_t slab = smem_addr(slabs + (s % S::kStages) * Wts::kSlabBytes) + b_lane;
    auto load_b = [&](int q) {
#pragma unroll
      for (int j = 0; j < S::kJ; ++j) {
#pragma unroll
        for (int gp = 0; gp < 2; ++gp) {
          Wts::load(bf[q % 2][j][gp], slab + Wts::offset(q, j, gp));
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
            const uint32_t b0 = bf[q % 2][j][g / 2][(g % 2) * 2];
            const uint32_t b1 = bf[q % 2][j][g / 2][(g % 2) * 2 + 1];
            if constexpr (std::is_same<M, S8>::value) {
              mma_s8(acc[r][j][g], af[n % 2], b0, b1);
            } else {
              mma_bf16(acc[r][j][g], af[n % 2], b0, b1);
            }
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
// is a pair over the two channels (float2 of f32 sums, int2 of s32 ones).
template <int CH, typename V, typename F>
__device__ __forceinline__ void for_each_pair(
    const V (&acc)[Shape<CH>::kRows][Shape<CH>::kJ][4][4], F&& f) {
  using S = Shape<CH>;
  using V2 = typename std::conditional<std::is_same<V, int>::value, int2, float2>::type;
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
          V2{acc[r][j][0][e], acc[r][j][0][e + 1]}, V2{acc[r][j][1][e], acc[r][j][1][e + 1]},
          V2{acc[r][j][2][e], acc[r][j][2][e + 1]}, V2{acc[r][j][3][e], acc[r][j][3][e + 1]});
      }
    }
  }
}

}  // namespace convlstm_mma
