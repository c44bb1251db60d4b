"""PyTorch port: the redesigned axial attention (K4) and channel-major 3x3
head (K6b). What runs on the CPU: the rule that picks one of K4's three
kernels, the wrappers' checks (meta tensors stand in for a card), the plain
versions against the JAX functions at the new shapes scaled down, and the
source guards of the two tensor-core kernels.

Inputs come from numpy seeds and go to both packages. The JAX attention kernel
runs in the Pallas interpreter where it can (else its reference), the JAX head
in interpret mode at a geometry its gate admits and through its reference at
the others, as ``tests/test_pallas_attn.py`` and ``tests/test_cmajor.py`` run
them.

Tolerances: float32 at 1e-5 (attention: the same f32 softmax, summed in
another order) and 2e-5 for the head (sums of 9 * Cin products; as
``tests/test_torch_cmajor.py``).
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import satflow_tpu.ops.pallas.axial_attention as JA
import satflow_tpu.ops.pallas.cmajor_convlstm as JCM
import satflow_tpu_torch
from satflow_tpu_torch.ops import axial_attention as A
from satflow_tpu_torch.ops import cmajor_convlstm as CM

CSRC = Path(satflow_tpu_torch.__file__).resolve().parent / "csrc"
F32, BF16 = torch.float32, torch.bfloat16


# -- K4: the rule ----------------------------------------------------------------

@pytest.mark.parametrize("length, dim, dtype, want", [
    (16, 8, BF16, "rows"), (16, 8, F32, "rows"),         # MetNet's
    (1, 1, F32, "rows"), (1, 1, BF16, "rows"),           # the domain's least
    (32, 32, BF16, "rows"), (32, 32, F32, "rows"),       # the rows regime's far corner
    (33, 32, BF16, "mma"), (33, 32, F32, "tile"),        # one past it, along L
    (32, 33, BF16, "mma"), (32, 33, F32, "tile"),        # and along D
    (17, 24, BF16, "rows"), (1, 256, BF16, "mma"), (1, 256, F32, "tile"),
    (512, 1, BF16, "mma"), (512, 1, F32, "tile"),
    (64, 32, BF16, "mma"), (64, 64, BF16, "mma"),        # between the regimes
    (128, 64, BF16, "mma"), (256, 64, BF16, "mma"), (256, 64, F32, "tile"),
    (512, 256, BF16, "mma"), (512, 256, F32, "tile"),    # the caps
    (100, 100, BF16, "mma"), (100, 100, F32, "tile"),
])
def test_attention_regime(length, dim, dtype, want):
    assert A.regime(length, dim, dtype) == want


@pytest.mark.parametrize("length, dim, dtype, error", [
    (0, 8, F32, ValueError), (513, 8, F32, ValueError), (16, 0, BF16, ValueError),
    (16, 257, BF16, ValueError), (16, 8, torch.float16, TypeError),
    (16, 8, torch.float64, TypeError),
])
def test_attention_regime_refuses_what_lies_outside(length, dim, dtype, error):
    with pytest.raises(error):
        A.regime(length, dim, dtype)


def test_attention_regime_covers_the_domain():
    """Every (L, D) of the domain has exactly one kernel in either type, and the
    rows regime is a corner of it."""
    for dtype, other in ((F32, "tile"), (BF16, "mma")):
        for length in (1, 2, 15, 16, 17, 31, 32, 33, 64, 65, 127, 128, 256, 511, 512):
            for dim in (1, 7, 8, 9, 16, 24, 31, 32, 33, 64, 100, 128, 255, 256):
                rows = length <= A.ROWS_MAX_LEN and dim <= A.ROWS_MAX_DIM
                assert A.regime(length, dim, dtype) == ("rows" if rows else other)
    assert (A.ROWS_MAX_LEN, A.ROWS_MAX_DIM, A.MAX_LEN, A.MAX_DIM) == (32, 32, 512, 256)


def test_attention_rule_is_stated():
    doc = A.__doc__
    for word in ('"rows"', '"mma"', '"tile"', "regime", "L <= 32 and D <= 32", "mma.sync"):
        assert word in doc, word
    src = (CSRC / "axial_attention.cu").read_text()
    assert "kRowsMaxL = 32" in src and "kRowsMaxD = 32" in src  # the source's copy of the rule


@pytest.mark.parametrize("shape", [(3, 16, 8), (2, 64, 32), (2, 130, 24), (1, 512, 256),
                                   (5, 1, 1), (2, 33, 32)])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_attention_checks_pass_on_meta_tensors(shape, dtype):
    """Off the CPU every shape of the domain passes the wrapper's checks up to
    the device type, in every regime: nothing routes to the plain version."""
    q = torch.empty(*shape, dtype=dtype, device="meta")
    assert A.kernel_takes(q, q, q)
    assert A.regime(shape[1], shape[2], dtype) in ("rows", "mma", "tile")
    with pytest.raises(ValueError, match="cpu or cuda tensors, not meta"):
        A.attention_kernel(q, q, q)
    with pytest.raises(TypeError, match="k is"):
        A.attention_kernel(q, q.to(torch.float64), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        A.attention_kernel(q.to(torch.float16), q.to(torch.float16), q.to(torch.float16))


# -- K4: the plain version against the JAX functions -----------------------------

def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


ATTN_SHAPES = [(6, 64, 32), (3, 130, 24), (6, 16, 8), (2, 64, 64), (2, 128, 64), (1, 17, 100),
               (4, 1, 8), (2, 100, 1)]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_ref_matches_jax_ref(shape):
    q, k, v = _qkv(shape, seed=sum(shape))
    want = np.asarray(JA._attention_ref(*(jnp.asarray(a) for a in (q, k, v))))
    got = A.axial_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("shape", [(6, 64, 32), (3, 130, 24), (8, 16, 8), (2, 128, 64)])
def test_attention_ref_matches_jax_kernel(monkeypatch, shape):
    """Against ``_attention_pallas`` in the Pallas interpreter (the kernel has no
    interpret switch of its own: the call is patched to ask for it)."""
    monkeypatch.setattr(JA.pl, "pallas_call",
                        functools.partial(JA.pl.pallas_call, interpret=True))
    q, k, v = _qkv(shape, seed=1 + sum(shape))
    want = np.asarray(JA._attention_pallas(*(jnp.asarray(a) for a in (q, k, v))))
    got = A.axial_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("shape", [(6, 64, 32), (3, 130, 24)])
def test_attention_ref_bf16_matches_jax_ref(shape):
    """bfloat16: q * scale rounded to bf16 first, f32 inside, one rounding of the
    output, on both sides: one bf16 step."""
    q, k, v = _qkv(shape, seed=2 + sum(shape))
    want = JA._attention_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = A.axial_attention_ref(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-2, rtol=2 ** -7)


# -- K6b: the plain version against the JAX functions ----------------------------

def _head_inputs(b, hgt, wdt, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, hgt, wdt, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return x, w, bias


HEAD_SHAPES = [(2, 10, 18, 1, 1), (2, 10, 18, 12, 16), (2, 10, 18, 1, 16), (2, 10, 18, 12, 1),
               (1, 7, 5, 64, 12), (1, 33, 40, 128, 16)]


@pytest.mark.parametrize("b, hgt, wdt, cin, cout", HEAD_SHAPES)
def test_head_ref_matches_jax(b, hgt, wdt, cin, cout):
    """At geometries the JAX gate does not admit (W % 128 != 0 or Cin % 8 != 0)
    its head runs its reference: the port's plain version agrees with it, pad
    rows dropped."""
    x, w, bias = _head_inputs(b, hgt, wdt, cin, cout, seed=cin + cout)
    bh = JCM.default_block_h(hgt)
    want = JCM.cmajor_conv3x3(JCM.to_cmajor(jnp.asarray(x), bh), jnp.asarray(w),
                              jnp.asarray(bias), bh, hgt, wdt)
    want = np.asarray(JCM.from_cmajor(want, hgt, wdt, bh))
    got = CM.cmajor_conv3x3(CM.to_cmajor(torch.from_numpy(x)), torch.from_numpy(w),
                            torch.from_numpy(bias), hgt, wdt)
    assert got.shape == (b, cout, hgt * wdt)
    np.testing.assert_allclose(CM.from_cmajor(got, hgt, wdt).numpy(), want, atol=2e-5)


@pytest.mark.parametrize("cin, cout", [(8, 1), (8, 12), (16, 16)])
def test_head_ref_matches_jax_kernel(monkeypatch, cin, cout):
    """Against ``_conv_pallas`` in interpret mode at a geometry its gate admits."""
    monkeypatch.setattr(JCM, "_INTERPRET", True)
    hgt, wdt, bh = 16, 128, 4
    x, w, bias = _head_inputs(2, hgt, wdt, cin, cout, seed=10 + cin + cout)
    want = JCM._conv_pallas(JCM.to_cmajor(jnp.asarray(x), bh),
                            JCM.conv_weights_cmajor(jnp.asarray(w)),
                            jnp.asarray(bias).reshape(-1, 1), bh, hgt, wdt)
    want = np.asarray(JCM.from_cmajor(want, hgt, wdt, bh))
    got = CM.cmajor_conv3x3_ref(CM.to_cmajor(torch.from_numpy(x)), torch.from_numpy(w),
                                torch.from_numpy(bias), hgt, wdt)
    np.testing.assert_allclose(CM.from_cmajor(got, hgt, wdt).numpy(), want, atol=2e-5)


@pytest.mark.parametrize("cin, cout, hgt, wdt", [(1, 1, 10, 18), (12, 16, 10, 18),
                                                 (128, 16, 7, 5), (64, 12, 256, 256)])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_head_checks_pass_on_meta_tensors(cin, cout, hgt, wdt, dtype):
    """Off the CPU the head's whole domain (Cin <= 128, Cout <= 16, any image)
    passes the wrapper's checks up to the device type; outside it raises."""
    def t(*shape):
        return torch.empty(*shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="cpu or cuda tensors, not meta"):
        CM.cmajor_conv3x3(t(2, cin, hgt * wdt), t(3, 3, cin, cout), t(cout), hgt, wdt)
    with pytest.raises(ValueError, match="Cin <= 128 and 1 <= Cout <= 16"):
        CM.cmajor_conv3x3(t(2, cin, hgt * wdt), t(3, 3, cin, 17), t(17), hgt, wdt)
    with pytest.raises(ValueError, match="Cin <= 128 and 1 <= Cout <= 16"):
        CM.cmajor_conv3x3(t(2, 136, hgt * wdt), t(3, 3, 136, cout), t(cout), hgt, wdt)


# -- the sources -----------------------------------------------------------------

def _code(path: Path) -> str:
    """A CUDA source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("name, kernels", [
    ("axial_attention.cu", ("axial_attention_rows_kernel", "axial_attention_mma_kernel",
                            "axial_attention_tile_kernel")),
    ("cmajor_convlstm.cu", ("cmajor_conv_mma_kernel", "cmajor_conv_kernel",
                            "cmajor_cell_kernel")),
])
def test_products_are_written_in_the_kernels(name, kernels):
    """Both products of K4 and K6b's contraction are computed in the kernels'
    own bodies: tensor-core instructions in inline PTX, no library call."""
    code = _code(CSRC / name)
    for kernel in kernels:
        assert re.search(rf"__global__[^;{{]*\b{kernel}\b", code), kernel
    mma = code if name == "axial_attention.cu" else code + _code(CSRC / "convlstm_mma.cuh")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma
    assert "ldmatrix.sync.aligned" in mma
    assert "mma_bf16(" in code and "ldmatrix_x4_trans(" in code
    for word in ("cudnn", "cublas", "cutlass", "torch", "at::"):
        assert word not in code.lower(), word


def test_chip_smoke_profiles_name_the_new_kernels():
    """The profile classes of ``chip_smoke.py`` go by kernel name: the new
    ``__global__`` functions are listed, or their device time lands in "other"."""
    text = (Path(satflow_tpu_torch.__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    for kernel in ("axial_attention_rows_kernel", "axial_attention_mma_kernel",
                   "axial_attention_tile_kernel", "cmajor_conv_mma_kernel",
                   "cmajor_conv_kernel"):
        assert f'"{kernel}"' in text, kernel


def test_time_redesign_reads_the_ptxas_report():
    from satflow_tpu_torch.tools import time_redesign

    log = (
        "ptxas info    : Compiling entry function '_ZN3abc26axial_attention_mma_kernelILi64ELi2EEEv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 182 registers, 468 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN3abc22cmajor_conv_mma_kernelEPK' for 'sm_90a'\n"
        "    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 80 registers, 468 bytes cmem[0]\n")
    assert time_redesign.ptxas_report(log) == [
        ("_ZN3abc26axial_attention_mma_kernelILi64ELi2EEEv", 182, 0),
        ("_ZN3abc22cmajor_conv_mma_kernelEPK", 80, 20)]
    assert time_redesign.ptxas_report("") == []
    assert (24576, 16, 8) in time_redesign.K4_SHAPES and len(time_redesign.K4_SHAPES) == 6


@pytest.mark.skipif(torch.cuda.is_available(), reason="refuses only without a card")
def test_time_redesign_needs_a_card():
    from satflow_tpu_torch.tools import time_redesign

    with pytest.raises(SystemExit, match="needs a CUDA card"):
        time_redesign.main()
