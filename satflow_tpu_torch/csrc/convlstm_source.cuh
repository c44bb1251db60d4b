// Where the window of a ConvLSTM step's tile comes from: the one part of the
// gate contraction that differs between the step kernels that share it
// (convlstm_mma.cuh on the tensor cores, convlstm_tile.cuh on the CUDA cores).
//
// A source stages the tile's window, window_rows x kHaloW pixels around
// (y0 - 1, x0 - 1), each pixel [x | zeros | h | zeros], with the zeros of SAME
// padding written in, in one of three formats:
//
//   stage_bf16<CH>(window, pitch, kt, cxp, window_rows, y0, x0)
//     bf16, pitch bytes a pixel, x's channels padded to cxp, kt = cxp + h's
//     channels padded to a multiple of 16; by cp.async (the caller commits
//     the group) or plain stores (the caller's __syncthreads() publishes them)
//   stage_s8<CH>(window, pitch, kt, cxp, window_rows, y0, x0)
//     the same in int8 (ImageRows only), x's and h's channels each padded to
//     a multiple of 32
//   stage_f32(window, cin, cxp, window_rows, y0, x0)
//     f32, cin = cxp + CH values a pixel, x's channels padded to cxp
//
// The sources:
//   ImageRows   K1, K2 (bf16, f32), K5 (int8): NHWC x and h; zeros outside
//               the image
//   HaloRows    K1h: NHWC x and h, but the row above and the row below each
//               8-row block come from the side tensors x_halo, h_halo
//               (B, H/8, 2, W, C), which hold the image's edge zeros; so no
//               row is tested, only the W boundary
//   CmajorRows  K6a: channel-major x (B, Cx, H*W) and h (B, CH, H*W); the bf16
//               window is a transpose: 8 pixels x 8 channels a thread, read as
//               eight 16-byte pieces of eight channel planes and written as
//               eight 16-byte pixel rows (stage_cmajor_bf16, shared with K6b),
//               so that a tap stays a row offset into the window
//   PadRows     T3: CmajorRows over the prototype's pad-row planes (B, C, SP),
//               SP = (H + 2 block_h) * W, whose block_h zero rows above and
//               below the image are in memory
//   PadColumns  T1, T2, K1p (bf16): the study steps' W-padded NHWC xp (B, H,
//               W+2, Cx) and hp (B, H, W+2, Ch), whose two halo columns are
//               in memory and read as given; zeros above and below the image

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "convlstm_mma.cuh"
#include "convlstm_tile.cuh"

namespace convlstm_source {

using convlstm_mma::cp_async_16_or_zeros;
using convlstm_tile::kHaloW;
using convlstm_tile::kThreads;
using convlstm_tile::to_f32;

constexpr int kHaloBlockH = 8;  // rows of a row block of the halo variant

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Eight channels' runs of 8 bf16 pixels, channel c as the four words v[c][0..3]
// -> the 8 pixels' runs of 8 channels, stored as 16-byte rows at dst + p * pitch.
__device__ __forceinline__ void store_transposed_8x8(const unsigned int (&v)[8][4],
                                                     unsigned char* dst, int pitch) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    // pixel p is the low (p even) or high half of word p / 2 of every channel
    const unsigned int sel = (p & 1) ? 0x7632u : 0x5410u;
    uint4 o;
    o.x = __byte_perm(v[0][p / 2], v[1][p / 2], sel);
    o.y = __byte_perm(v[2][p / 2], v[3][p / 2], sel);
    o.z = __byte_perm(v[4][p / 2], v[5][p / 2], sel);
    o.w = __byte_perm(v[6][p / 2], v[7][p / 2], sel);
    *reinterpret_cast<uint4*>(dst + p * pitch) = o;
  }
}

// The bf16 [pixel][channel] window of channel-major planes (K6a's step, K6b's
// head): window_rows x kCols pixels around image pixel (y0 - 1, x0 - 1),
// pitch bytes a pixel, channel group cg (8 channels) at byte 16 cg of it.
// plane(cg, n) returns group cg's first plane (H*W elements each) and sets n
// to how many of its 8 channels exist; value(c, gy, gx) is channel c at image
// pixel (gy, gx) as f32, zero outside the image and past the channels. Where
// `vec` (W a multiple of 8 and every plane 16-byte aligned: a run of 8 pixels
// is then an aligned piece, inside the image or outside it whole) the kCols -
// 2 interior columns go as 8 x 8 transposes, 8 pixels of 8 planes a thread,
// read as eight 16-byte pieces and written as eight 16-byte pixel rows; the
// two halo columns, and the whole window where !vec, go by the element. A tap
// is then a row offset into the window and every ldmatrix row is aligned.
template <int kCols, typename Plane, typename Value>
__device__ __forceinline__ void stage_cmajor_bf16(unsigned char* window, int pitch, int ngroups,
                                                  int window_rows, int height, int width,
                                                  int y0, int x0, bool vec, Plane plane,
                                                  Value value) {
  const int nchan = ngroups * 8;
  auto stage_elements = [&](int col_step, int cols) {
    for (int i = threadIdx.x; i < window_rows * cols * nchan; i += kThreads) {
      const int c = i % nchan;
      const int pix = i / nchan;
      const int col = (pix % cols) * col_step;
      const int r = pix / cols;
      reinterpret_cast<__nv_bfloat16*>(window + (r * kCols + col) * pitch)[c] =
          __float2bfloat16(value(c, y0 - 1 + r, x0 - 1 + col));
    }
  };
  if (!vec) {
    stage_elements(1, kCols);
    return;
  }
  constexpr int kRuns = (kCols - 2) / 8;  // runs of 8 interior pixels a window row
  for (int i = threadIdx.x; i < window_rows * kRuns * ngroups; i += kThreads) {
    const int cg = i % ngroups;
    const int run = (i / ngroups) % kRuns;
    const int r = i / (ngroups * kRuns);
    const int gy = y0 - 1 + r;
    const int gx = x0 + run * 8;
    const bool in = gy >= 0 && gy < height && gx < width;
    int n_valid = 0;
    const __nv_bfloat16* first = plane(cg, n_valid);
    const size_t hw = size_t(height) * width;
    unsigned int v[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (in && c < n_valid) {
        u = __ldg(reinterpret_cast<const uint4*>(first + c * hw + size_t(gy) * width + gx));
      }
      v[c][0] = u.x; v[c][1] = u.y; v[c][2] = u.z; v[c][3] = u.w;
    }
    store_transposed_8x8(v, window + (r * kCols + 1 + run * 8) * pitch + cg * 16, pitch);
  }
  stage_elements(kCols - 1, 2);  // the two halo columns
}

// The bf16 or int8 window of an NHWC source (element E): 16-byte pieces of 8
// bf16 or 16 int8 channels, copied asynchronously; a pixel's pieces go to 8,
// 16 or 32 neighbouring lanes. kt and cxp count elements. A piece that is not
// whole in memory (x where its rows are not whole aligned pieces; h at CH = 8
// in int8) is gathered by the element and stored.
template <int CH, typename E, typename Src>
__device__ __forceinline__ void stage_nhwc(const Src& src, unsigned char* window, int pitch,
                                           int kt, int cxp, int window_rows, int y0, int x0) {
  constexpr int kPer = 16 / int(sizeof(E));      // elements a piece
  constexpr bool kHWhole = CH % kPer == 0;       // h's rows are whole pieces
  const int cx = src.cx;
  const int pieces = kt / kPer;
  const int lane_bits = pieces <= 8 ? 3 : pieces <= 16 ? 4 : 5;
  const int sub = threadIdx.x & ((1 << lane_bits) - 1);
  const bool x_vec = cx % kPer == 0 && src.x_aligned();
  // a piece of n elements from p, zeros after them
  auto gather = [](unsigned char* dst, const E* p, int n) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    E* e = reinterpret_cast<E*>(&u);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j < n) e[j] = p[j];
    }
    *reinterpret_cast<uint4*>(dst) = u;
  };
  for (int pix = threadIdx.x >> lane_bits; pix < window_rows * kHaloW;
       pix += kThreads >> lane_bits) {
    const E* xs = nullptr;
    const E* hs = nullptr;
    const bool inside = src.at(y0 - 1 + pix / kHaloW, x0 - 1 + pix % kHaloW, xs, hs);
    for (int k = sub * kPer; k < kt; k += kPer << lane_bits) {
      unsigned char* dst = window + pix * pitch + k * int(sizeof(E));
      // where nothing is read, h stands in as an aligned address
      if (k >= cxp) {
        const bool valid = inside && k - cxp < CH;
        if (kHWhole || !valid) {
          cp_async_16_or_zeros(dst, valid ? hs + (k - cxp) : src.h, valid);
        } else {
          gather(dst, hs + (k - cxp), CH - (k - cxp));
        }
      } else if (x_vec || !inside || k >= cx) {
        // a whole aligned piece of x, or zeros
        const bool whole = inside && k + kPer <= cx;
        cp_async_16_or_zeros(dst, whole ? xs + k : src.h, whole);
      } else {
        gather(dst, xs + k, cx - k);
      }
    }
  }
}

// The f32 window of an NHWC source, by the element.
template <typename Src>
__device__ __forceinline__ void stage_nhwc_f32(const Src& src, float* window, int cin, int cxp,
                                               int window_rows, int y0, int x0) {
  const int cx = src.cx;
  const int n = window_rows * kHaloW * cin;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int ci = i % cin;
    const int pix = i / cin;
    float v = 0.f;
    decltype(src.x) xs = nullptr;
    decltype(src.h) hs = nullptr;
    if ((ci < cx || ci >= cxp) && src.at(y0 - 1 + pix / kHaloW, x0 - 1 + pix % kHaloW, xs, hs)) {
      v = ci < cx ? to_f32(xs[ci]) : to_f32(hs[ci - cxp]);
    }
    window[i] = v;
  }
}

// K1, K2 (bf16, f32) and K5 (int8): NHWC x (B, H, W, cx) and h (B, H, W, ch) of
// image b.
template <typename T>
struct ImageRows {
  const T* x;
  const T* h;
  int b, height, width, cx, ch;

  // x's and h's channels at image pixel (gy, gx), or false for a zero of SAME
  // padding.
  __device__ __forceinline__ bool at(int gy, int gx, const T*& xs, const T*& hs) const {
    if (gy < 0 || gy >= height || gx < 0 || gx >= width) return false;
    const size_t p = (size_t(b) * height + gy) * width + gx;
    xs = x + p * cx;
    hs = h + p * ch;
    return true;
  }
  __device__ __forceinline__ bool x_aligned() const { return aligned16(x); }
  template <int CH>
  __device__ __forceinline__ void stage_bf16(unsigned char* window, int pitch, int kt, int cxp,
                                             int window_rows, int y0, int x0) const {
    stage_nhwc<CH, T>(*this, window, pitch, kt, cxp, window_rows, y0, x0);
  }
  template <int CH>
  __device__ __forceinline__ void stage_s8(unsigned char* window, int pitch, int kt, int cxp,
                                           int window_rows, int y0, int x0) const {
    stage_nhwc<CH, T>(*this, window, pitch, kt, cxp, window_rows, y0, x0);
  }
  __device__ __forceinline__ void stage_f32(float* window, int cin, int cxp, int window_rows,
                                            int y0, int x0) const {
    stage_nhwc_f32(*this, window, cin, cxp, window_rows, y0, x0);
  }
};

// K1h: as ImageRows, but rows outside the 8-row block that holds the tile
// (rows row0 .. row0 + 7) come from the side tensors: the row above from
// x_halo[b, row0 / 8, 0], the row below from x_halo[b, row0 / 8, 1] (h alike).
// H is a multiple of 8.
template <typename T>
struct HaloRows {
  const T* x;
  const T* h;
  const T* x_halo;
  const T* h_halo;
  int b, height, width, cx, ch, row0;

  __device__ __forceinline__ bool at(int gy, int gx, const T*& xs, const T*& hs) const {
    if (gx < 0 || gx >= width) return false;
    size_t p;
    if (gy < row0 || gy >= row0 + kHaloBlockH) {
      const int side = gy < row0 ? 0 : 1;
      p = ((size_t(b) * (height / kHaloBlockH) + row0 / kHaloBlockH) * 2 + side) * width + gx;
      xs = x_halo + p * cx;
      hs = h_halo + p * ch;
    } else {
      p = (size_t(b) * height + gy) * width + gx;
      xs = x + p * cx;
      hs = h + p * ch;
    }
    return true;
  }
  __device__ __forceinline__ bool x_aligned() const { return aligned16(x) && aligned16(x_halo); }
  template <int CH>
  __device__ __forceinline__ void stage_bf16(unsigned char* window, int pitch, int kt, int cxp,
                                             int window_rows, int y0, int x0) const {
    stage_nhwc<CH, T>(*this, window, pitch, kt, cxp, window_rows, y0, x0);
  }
  __device__ __forceinline__ void stage_f32(float* window, int cin, int cxp, int window_rows,
                                            int y0, int x0) const {
    stage_nhwc_f32(*this, window, cin, cxp, window_rows, y0, x0);
  }
};

// K6a: channel-major x (B, cx, H*W) and h (B, ch, H*W) of image b.
template <typename T>
struct CmajorRows {
  const T* x;
  const T* h;
  int b, height, width, cx, ch;

  // channel c of [x | h] (c < cx: x's; cxp <= c: h's c - cxp) at window pixel
  // (gy, gx), zero outside the image and in the padding
  __device__ __forceinline__ float value(int c, int cxp, int gy, int gx) const {
    if (gy < 0 || gy >= height || gx < 0 || gx >= width) return 0.f;
    const size_t yx = size_t(gy) * width + gx;
    const size_t hw = size_t(height) * width;
    if (c < cx) return to_f32(x[(size_t(b) * cx + c) * hw + yx]);
    if (c >= cxp && c - cxp < ch) return to_f32(h[(size_t(b) * ch + (c - cxp)) * hw + yx]);
    return 0.f;
  }

  // The bf16 window (stage_cmajor_bf16): x's channel groups, then h's.
  template <int CH>
  __device__ __forceinline__ void stage_bf16(unsigned char* window, int pitch, int kt, int cxp,
                                             int window_rows, int y0, int x0) const {
    const size_t hw = size_t(height) * width;
    const int cxg = cxp / 8;  // of the groups of 8 channels of [x | h], x's
    stage_cmajor_bf16<kHaloW>(
        window, pitch, kt / 8, window_rows, height, width, y0, x0,
        width % 8 == 0 && aligned16(x) && aligned16(h),
        [&](int cg, int& n) {
          n = cg < cxg ? cx - cg * 8 : ch - (cg - cxg) * 8;
          return cg < cxg ? x + (size_t(b) * cx + cg * 8) * hw
                          : h + (size_t(b) * ch + (cg - cxg) * 8) * hw;
        },
        [&](int c, int gy, int gx) { return value(c, cxp, gy, gx); });
  }

  // The f32 window by the element, neighbouring threads on neighbouring
  // pixels of a plane.
  __device__ __forceinline__ void stage_f32(float* window, int cin, int cxp, int window_rows,
                                            int y0, int x0) const {
    const int npix = window_rows * kHaloW;
    for (int i = threadIdx.x; i < npix * cin; i += kThreads) {
      const int pix = i % npix;
      const int c = i / npix;
      window[pix * cin + c] = value(c, cxp, y0 - 1 + pix / kHaloW, x0 - 1 + pix % kHaloW);
    }
  }
};

// T3: the channel-major prototype's carries x and h (B, C, SP), SP = rows *
// width, rows = H + 2 block_h: each plane is the image with block_h zero rows
// above and below, in memory. The tile's rows (y0 and the window's) count
// from the first pad row, and the planes are staged as CmajorRows stages an
// image of `rows` rows: the rows above the first pad row and below the last
// are SAME zeros, but only pad rows of the output read them, and those the
// kernel writes as zeros; an image row's window lies in memory, its rows
// above and below the image the pad rows' real zeros. So no row is tested
// against the image, only the W boundary (and the planes' ends).
template <typename T>
struct PadRows : CmajorRows<T> {
  __device__ PadRows(const T* x, const T* h, int b, int rows, int width, int c)
      : CmajorRows<T>{x, h, b, rows, width, c, c} {}
};

// T1, T2 and K1p: W-padded NHWC xp (B, H, W+2, cx) and hp (B, H, W+2, ch) of
// image b, width the unpadded W. Window column j is padded column x0 + j, so
// image column gx is padded column gx + 1 and the halo columns are read from
// memory as given (the caller keeps them zero); rows outside the image, and
// columns past W + 1 in the last column tile, are zeros.
template <typename T>
struct PadColumns {
  const T* x;
  const T* h;
  int b, height, width, cx, ch;

  __device__ __forceinline__ bool at(int gy, int gx, const T*& xs, const T*& hs) const {
    if (gy < 0 || gy >= height || gx < -1 || gx > width) return false;
    const size_t p = (size_t(b) * height + gy) * (width + 2) + (gx + 1);
    xs = x + p * cx;
    hs = h + p * ch;
    return true;
  }
  __device__ __forceinline__ bool x_aligned() const { return aligned16(x); }
  template <int CH>
  __device__ __forceinline__ void stage_bf16(unsigned char* window, int pitch, int kt, int cxp,
                                             int window_rows, int y0, int x0) const {
    stage_nhwc<CH, T>(*this, window, pitch, kt, cxp, window_rows, y0, x0);
  }
};

}  // namespace convlstm_source
