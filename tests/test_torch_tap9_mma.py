"""PyTorch port, the study kernels T1, T2 and their yardstick K1p on the tensor
cores (``csrc/exp_tap9.cu``), on the CPU: the sources, where the kernels find
their weight rows, and the order they walk the contraction in.

The kernels run only on a card (``tests/test_torch_gpu.py``); here:

- the sources: the bf16 entry points reach the shared tensor-core
  contraction (``convlstm_mma.cuh``) with a ``PadColumns`` window, the
  weights read as given through ``StridedWeights``, and ``RowWalk`` for T2
  and K1p; the f32 path keeps its CUDA-core loop; no library call;
- ``weight_rows``: the rows its (base, sy, sx) triples select from the
  flattened w9 and w3 are ``Wx[ky, kx, ci]`` and ``Wh[ky, kx, ci]`` (exact);
- the two walks, mirrored step for step from ``Walk`` and ``RowWalk``: each
  visits every k step once, no k step straddles x and h, and the weight rows
  they multiply come in the JAX kernels' im2col order (``tools/exp_tap9.py``:
  T1's per-tap ``[x | h]``, T2's per-dy ``[x dx 0-2 | h dx 0-2]``, the main
  kernel's order), which is each tensor front to back (exact).
"""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satflow_tpu_torch
from satflow_tpu_torch.tools import exp_tap9 as XT

CSRC = Path(satflow_tpu_torch.__file__).resolve().parent / "csrc"
WIDTHS = [(12, 8), (12, 32), (64, 8), (64, 32)]


def _code(name: str) -> str:
    """A CUDA source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", (CSRC / name).read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


# -- the sources --------------------------------------------------------------------


def _between(code: str, start: str, end: str) -> str:
    return code.split(start, 1)[1].split(end, 1)[0]


def test_bf16_study_kernels_reach_the_tensor_core_contraction():
    """The bf16 kernel stages a PadColumns window and contracts through
    convlstm_mma::gate_preactivations with StridedWeights, in RowWalk's order
    or Walk's by a template flag; it holds no CUDA-core loop of its own."""
    code = _code("exp_tap9.cu")
    assert '#include "convlstm_gates.cuh"' in code
    bf16 = _between(code, "padded_mma_kernel(", "struct PaddedF32")
    assert "PadColumns<__nv_bfloat16> src{" in bf16
    assert "convlstm_mma::StridedWeights<CH> weights{w, x_rows, h_rows}" in bf16
    assert re.search(r"std::conditional<kRowOrder, convlstm_mma::RowWalk<CH>,\s*"
                     r"convlstm_mma::Walk>", bf16)
    assert re.search(r"convlstm_mma::gate_preactivations<CH, convlstm_mma::Bf16, Order>\(", bf16)
    assert "convlstm_mma::for_each_pair<CH>(" in bf16
    for word in ("accumulate<", "fmaf(", "init_with_bias", "mma_bf16(", "ldmatrix"):
        assert word not in bf16, word


def test_each_bf16_entry_takes_its_walk():
    """T1's bf16 entry walks tap by tap (Walk, K1's order); T2's, its sums
    entry and K1p's walk in the JAX main kernel's order (RowWalk)."""
    code = _code("exp_tap9.cu")
    assert re.search(r"launch_for_width<PaddedMma<!kTapMajor, kGates>::template Step,"
                     r"\s*__nv_bfloat16, 128>", code)
    entries = dict(re.findall(r"SATFLOW_PADDED_BF16_ENTRY\((satflow_\w+), (\w+), \w+\)", code))
    assert entries == {"satflow_step_tap9_bf16": "true", "satflow_step_nogate_bf16": "false",
                       "satflow_step_padded_bf16": "false"}
    sums = _between(code, "int satflow_step_nogate_sums_bf16(", "}")
    assert "launch_bf16<false, false>(" in sums and "sums" in sums


def test_f32_study_kernels_stay_on_the_cuda_cores():
    """The float32 entries launch the CUDA-core kernel of convlstm_tile.cuh's
    inner product (``accumulate``), which holds no tensor-core instruction."""
    code = _code("exp_tap9.cu")
    f32 = _between(code, "padded_step_kernel(", "padded_mma_kernel(")
    assert "accumulate<CH>(" in f32 and "mma" not in f32 and "ldmatrix" not in f32
    assert re.search(r"launch_for_width<PaddedF32<kTapMajor, kGates>::template Step, float, 128>",
                     code)
    assert "padded_step_kernel<U, CH, kTapMajor, kGates>" in _between(code, "struct PaddedF32",
                                                                     "struct PaddedMma")
    assert '#include "convlstm_tile.cuh"' in _code("convlstm_gates.cuh")
    assert re.search(r"__device__ __forceinline__ void accumulate\(", _code("convlstm_tile.cuh"))


def test_shared_contraction_keeps_its_default_walk_and_hwio_weights():
    """The walk is a template parameter of gate_preactivations that defaults
    to Walk, so every other caller compiles to what it did; HwioWeights still
    takes Walk itself; StridedWeights and RowWalk are separate types."""
    mma = _code("convlstm_mma.cuh")
    assert re.search(r"template <int CH, typename M, typename W = Walk, typename Src, "
                     r"typename Wts>\s*__device__ __forceinline__ void gate_preactivations\(", mma)
    assert "W copied, multiplied;" in mma
    hwio = _between(mma, "struct HwioWeights {", "\n};")
    assert "Walk& copied" in hwio and "template <typename W>" not in hwio
    strided = _between(mma, "struct StridedWeights {", "\n};")
    assert "template <typename W>" in strided and "W& copied" in strided
    assert "x.base + ky * x.sy + kx * x.sx + k" in strided
    assert "h.base + ky * h.sy + kx * h.sx + (k - cxp / 2)" in strided
    assert "cp_async_16(dst, w + size_t(row) * (4 * CH) + col)" in strided
    assert re.search(r"template <int CH, typename M = Bf16>\s*struct RowWalk", mma)


def test_pad_columns_reads_the_halo_columns_as_given():
    """PadColumns maps image column gx to padded column gx + 1, reads columns
    -1 .. W from memory and stages through stage_nhwc (cp.async pieces)."""
    src = _between(_code("convlstm_source.cuh"), "struct PadColumns {", "\n};")
    assert "gx < -1 || gx > width" in src and "gy < 0 || gy >= height" in src
    assert "* (width + 2) + (gx + 1)" in src
    assert "stage_nhwc<CH, T>(*this" in src


def test_no_library_call_in_the_study_kernels():
    code = _code("exp_tap9.cu").lower()
    for word in ("cublas", "cudnn", "cutlass", "torch", "at::", "gemm("):
        assert word not in code, word


# -- where the weight rows are ---------------------------------------------------------


@pytest.mark.parametrize("cx, ch", WIDTHS)
@pytest.mark.parametrize("layout", ["tap9", "rows3"])
def test_weight_rows_select_the_hwio_weights(layout, cx, ch):
    """The (base, sy, sx) triples the wrapper hands the bf16 kernels find
    Wx[ky, kx, ci] and Wh[ky, kx, ci] among the rows of the flattened w9 or
    w3, as the wrapper builds them (exact)."""
    g = torch.Generator().manual_seed(cx * 1000 + ch)
    wx, wh = torch.randn(3, 3, cx, 4 * ch, generator=g), torch.randn(3, 3, ch, 4 * ch, generator=g)
    rows = XT._WEIGHTS[layout](wx, wh).reshape(-1, 4 * ch)
    assert rows.shape[0] == 9 * (cx + ch)
    (xb, xsy, xsx), (hb, hsy, hsx) = XT.weight_rows(layout, cx, ch)
    for ky in range(3):
        for kx in range(3):
            x_at = xb + ky * xsy + kx * xsx + torch.arange(cx)
            h_at = hb + ky * hsy + kx * hsx + torch.arange(ch)
            assert torch.equal(rows[x_at], wx[ky, kx]) and torch.equal(rows[h_at], wh[ky, kx])


def test_weight_rows_refuse_another_layout():
    with pytest.raises(ValueError, match="tap9 or rows3"):
        XT.weight_rows("hwio", 12, 8)


@pytest.mark.parametrize("cx, ch", [(4, 8), (12, 32)])
def test_nogate_sums_plain_version_is_the_unread_half_of_the_gates(cx, ch):
    """On CPU tensors ``step_nogate_sums`` is T2's plain step and the o + g
    sums of ``nogate_sums_ref``, which equal the gate slots 2 and 3 of two
    library convs on the interior (float64, atol 1e-5); no launch counted."""
    from satflow_tpu_torch.ops import fused_convlstm_step as P

    g = torch.Generator().manual_seed(cx + ch)
    x, h, c = (torch.randn(2, 9, 13, n, generator=g) for n in (cx, ch, ch))
    wx, wh = torch.randn(3, 3, cx, 4 * ch, generator=g) * 0.1, torch.randn(3, 3, ch, 4 * ch,
                                                                            generator=g) * 0.1
    b = torch.randn(4 * ch, generator=g) * 0.1
    args = (XT.pad_w(x), XT.pad_w(h), c, wx, wh, b)
    before = XT.step_nogate.launches
    h_t2, c_t2, og = XT.step_nogate_sums(*args)
    assert XT.step_nogate.launches == before
    want_h, want_c = XT.step_nogate_ref(*args)
    assert torch.equal(h_t2, want_h) and torch.equal(c_t2, want_c)
    gates = (P.conv3x3(x.double(), wx.double()) + P.conv3x3(h.double(), wh.double())
             + b.double())
    assert og.dtype == torch.float32 and og.shape == c.shape
    torch.testing.assert_close(og.double(), gates[..., 2 * ch:3 * ch] + gates[..., 3 * ch:],
                               atol=1e-5, rtol=0)


# -- the order of the walk -----------------------------------------------------------


def kernel_walk(order: str, cx: int, ch: int):
    """The (tap, k) of every k step of the bf16 kernels' walk, stepped as
    ``convlstm_mma.cuh`` steps it: ``Walk::next`` (order "tap") or
    ``RowWalk::next`` ("row"); k counts bytes of the tap's [x | 0 | h | 0],
    x's and h's bytes each rounded up to 32, a k step 32 bytes."""
    cxp = -(-2 * cx // 32) * 32
    kt = cxp + -(-2 * ch // 32) * 32
    tap, k, steps = 0, 0, []
    while tap < 9:
        steps.append((tap, k))
        k += 32
        if order == "tap":
            if k == kt:
                tap, k = tap + 1, 0
        elif k == cxp:
            if tap % 3 < 2:
                tap, k = tap + 1, 0
            else:
                tap -= 2
        elif k == kt:
            tap += 1
            k = 0 if tap % 3 == 0 else cxp
    return steps, cxp, kt


def walked_channels(order: str, cx: int, ch: int):
    """The (part, ky, kx, channel) that each real row of the walk's k steps
    multiplies, in the walk's order (the zero padding left out); asserts that
    no k step straddles x and h."""
    steps, cxp, kt = kernel_walk(order, cx, ch)
    assert len(steps) == len(set(steps)) == 9 * kt // 32
    out = []
    for tap, k in steps:
        channels = [k // 2 + r for r in range(16)]
        assert all(c < cxp // 2 for c in channels) or all(c >= cxp // 2 for c in channels)
        for c in channels:
            if c < cx:
                out.append(("x", tap // 3, tap % 3, c))
            elif cxp // 2 <= c < cxp // 2 + ch:
                out.append(("h", tap // 3, tap % 3, c - cxp // 2))
    return out


def jax_order(kernel: str, cx: int, ch: int):
    """The JAX study kernels' contraction order: T1 (``_make_kernel_tap9``)
    per (dy, dx) tap the channel concat [x | h]; T2 (``_make_kernel_nogate``,
    as the main kernel's im2col) per dy the windows of x at dx = 0, 1, 2 then
    of h."""
    parts = (("x", cx), ("h", ch))
    if kernel == "tap9":
        return [(p, dy, dx, c) for dy in range(3) for dx in range(3) for p, n in parts
                for c in range(n)]
    return [(p, dy, dx, c) for dy in range(3) for p, n in parts for dx in range(3)
            for c in range(n)]


def jax_weight_labels(kernel: str, cx: int, ch: int):
    """The label of every row of w9 (``step_tap9``) or w3 (``step_nogate``)
    as the JAX wrappers build them from labelled HWIO weights."""
    lx = [("x", ky, kx, c) for ky in range(3) for kx in range(3) for c in range(cx)]
    lh = [("h", ky, kx, c) for ky in range(3) for kx in range(3) for c in range(ch)]
    labels = lx + lh
    wx = jnp.arange(len(lx)).reshape(3, 3, cx, 1)
    wh = (len(lx) + jnp.arange(len(lh))).reshape(3, 3, ch, 1)
    if kernel == "tap9":
        w = jnp.concatenate([wx, wh], axis=2).reshape(9, cx + ch, 1)
    else:
        w = jnp.concatenate([wx.reshape(3, 3 * cx, 1), wh.reshape(3, 3 * ch, 1)], axis=1)
    return [labels[i] for i in np.asarray(w).reshape(-1)]


@pytest.mark.parametrize("cx, ch", WIDTHS + [(4, 16), (256, 128), (16, 64)])
@pytest.mark.parametrize("order, kernel, layout", [("tap", "tap9", "tap9"),
                                                   ("row", "nogate", "rows3")])
def test_walk_follows_the_jax_contraction_order(order, kernel, layout, cx, ch):
    """T1's walk (Walk) multiplies the rows in T1's JAX order and T2's and
    K1p's (RowWalk) in the main kernel's im2col order; through weight_rows
    each walks its weight tensor front to back."""
    walked = walked_channels(order, cx, ch)
    assert walked == jax_order(kernel, cx, ch)
    assert jax_weight_labels(kernel, cx, ch) == walked
    (xb, xsy, xsx), (hb, hsy, hsx) = XT.weight_rows(layout, cx, ch)
    rows = [(xb + ky * xsy + kx * xsx if p == "x" else hb + ky * hsy + kx * hsx) + c
            for p, ky, kx, c in walked]
    assert rows == list(range(9 * (cx + ch)))


def test_the_two_walks_differ_only_in_order():
    """At Cx = Ch = 64 the walks visit the same k steps, and RowWalk's first
    steps after x's tap (0, 0) are x's tap (0, 1), where Walk's are h's (0, 0)."""
    tap, _, _ = kernel_walk("tap", 64, 64)
    row, _, _ = kernel_walk("row", 64, 64)
    assert sorted(tap) == sorted(row) and tap != row
    assert tap[4] == (0, 128) and row[4] == (1, 0)


# -- the timing tool ------------------------------------------------------------------


def test_time_tap9_reads_the_machine_code(monkeypatch):
    """``tools/time_tap9.py`` reads ptxas' registers and spills, and digests a
    library's SASS over its instructions alone (not the file it names), with
    each study kernel's instruction, HMMA and FFMA count."""
    from satflow_tpu_torch.tools import time_tap9

    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117padded_mma_kernelILi64E"
           "Lb1ELb1EEEv' for 'sm_90a'\n    0 bytes stack frame, 8 bytes spill stores, 4 bytes "
           "spill loads\nptxas info    : Used 168 registers, 468 bytes cmem[0]\n")
    assert time_tap9.registers(log) == [
        ("_ZN12_GLOBAL__N_117padded_mma_kernelILi64ELb1ELb1EEEv", 168, 12)]
    listing = ("\tFunction : _ZN44_GLOBAL__N__{0}_11_exp_tap9_cu_{1}17padded_mma_kernelILi8ELb0"
               "ELb1EEEvPK13__nv_bf\n"
               "        /*0000*/  LDC R1, c[0x0][0x28] ;  /* 0x00000a00ff017b82 */\n"
               "        /*0010*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"
               "\tFunction : _ZN44_GLOBAL__N__{0}_11_exp_tap9_cu_{1}18padded_step_kernelIfLi8ELb1"
               "ELb1EEEvPKT_\n"
               "        /*0000*/  FFMA R1, R2, R3, R4 ;\n")
    build = types.SimpleNamespace(find_nvcc=lambda: "/cuda/bin/nvcc",
                                  load=lambda name: types.SimpleNamespace(_name="lib.so"))
    # the same machine code built from two directories: another identifier,
    # another anonymous-namespace hash
    for identifier, hashes in (("/a/exp_tap9.cu", ("3f25af6d", "768e60e5")),
                               ("/b/exp_tap9.cu", ("0badf00d", "12345678"))):
        text = f"Fatbin elf code: identifier = {identifier}\n" + listing.format(*hashes)
        monkeypatch.setattr(time_tap9.subprocess, "run",
                            lambda *a, out=text, **k: types.SimpleNamespace(stdout=out))
        report = time_tap9.sass_report(build, "exp_tap9").splitlines()
        if identifier.startswith("/a"):
            first = report[0]
        assert report[0] == first and report[0].startswith("exp_tap9: sass ")
        assert report[1:] == ["  padded_mma_kernel<Li8ELb0ELb1E>: instructions 2, HMMA 1, FFMA 0",
                              "  padded_step_kernel<fLi8ELb1ELb1E>: instructions 1, HMMA 0, FFMA 1"]
