"""PyTorch port, the LSTM gate tail K3 (``ops/fused_lstm.py``) around its two
kernels, on the CPU: the stated rule that picks the vector kernel or the
per-element one (``vector_path``), the entry points typed once per process,
the launch's checks, the op's CPU implementation, and the launch counts left
alone by the CPU path. The kernels themselves run only on a card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 9a); their arithmetic
is the plain version's, which ``tests/test_torch_metnet.py`` holds against
the JAX function."""

import pytest
import torch

from satflow_tpu_torch.ops import _build
from satflow_tpu_torch.ops import fused_lstm as G


@pytest.mark.parametrize("dtype, width", [(torch.bfloat16, 8), (torch.float32, 4)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("ch", [1, 3, 12, 64, 65, 256])
def test_vector_path_takes_whole_16_byte_vectors(dtype, width, ch):
    """Fresh (aligned) tensors take the vector kernel exactly when C is a
    multiple of the 16 bytes' channels: 8 in bfloat16, 4 in float32."""
    gates, c = torch.zeros(5, 4 * ch, dtype=dtype), torch.zeros(5, ch, dtype=dtype)
    assert G.VECTOR_WIDTH[dtype] == width
    assert G.vector_path(gates, c) == (ch % width == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_vector_path_refuses_an_offset_view(dtype):
    """A view one element into its storage is misaligned: the per-element
    kernel takes it, for the gates and for c alike; a view 16 bytes in is
    aligned again and takes the vector kernel."""
    rows, ch = 6, 64
    gates = torch.zeros(rows * 4 * ch + 16, dtype=dtype)
    c = torch.zeros(rows * ch + 16, dtype=dtype)
    whole_g, whole_c = gates[:rows * 4 * ch].view(rows, 4 * ch), c[:rows * ch].view(rows, ch)
    assert whole_g.data_ptr() % 16 == 0 and G.vector_path(whole_g, whole_c)
    one_g = gates[1:1 + rows * 4 * ch].view(rows, 4 * ch)
    one_c = c[1:1 + rows * ch].view(rows, ch)
    assert one_g.is_contiguous() and not G.vector_path(one_g, whole_c)
    assert not G.vector_path(whole_g, one_c)
    k = 16 // gates.element_size()
    assert G.vector_path(gates[k:k + rows * 4 * ch].view(rows, 4 * ch),
                         c[k:k + rows * ch].view(rows, ch))


def test_vector_path_refuses_other_dtypes_and_2_31_elements():
    half = torch.zeros(2, 32, dtype=torch.float16), torch.zeros(2, 8, dtype=torch.float16)
    assert not G.vector_path(*half)
    big = torch.empty(1, 4 * 64).expand(2 ** 25, 4 * 64), torch.empty(1, 64).expand(2 ** 25, 64)
    assert big[1].numel() == 2 ** 31 and not G.vector_path(*big)


def test_entry_points_are_typed_once(monkeypatch):
    """The first lookup loads the library and types both kernels' entry
    points; later lookups of either kernel in either dtype load nothing."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return f"<{name}>"

    def load_typed(name, entries, argtypes):
        calls.append((name, tuple(entries), len(argtypes)))
        return Lib()

    monkeypatch.setattr(_build, "load_typed", load_typed)
    monkeypatch.setattr(G, "_typed", None)
    _, first = G._entry(True, torch.bfloat16)
    assert first == "<satflow_fused_lstm_gates_vec_bf16>"
    loaded = list(calls)
    assert len(loaded) == 1 and loaded[0][0] == "fused_lstm_gates"
    assert set(loaded[0][1]) == {*G._ENTRY.values(), *G._VEC_ENTRY.values()}
    _, second = G._entry(True, torch.bfloat16)
    assert G._entry(False, torch.float32)[1] == "<satflow_fused_lstm_gates_f32>"
    assert second is first and calls == loaded


def test_cpu_path_launches_nothing():
    """CPU tensors take the plain version through the op: no count moves."""
    counts = lambda: (G.fused_lstm_gates.launches, G.fused_lstm_gates.vector_launches,  # noqa: E731
                      G.fused_lstm_gates.element_launches)
    before = counts()
    h, c = G.fused_lstm_gates(torch.randn(3, 4, 32), torch.randn(3, 4, 8))
    assert h.shape == c.shape == (3, 4, 8) and counts() == before


@pytest.mark.parametrize("gates, c, error, match", [
    (torch.zeros(3, 32), torch.zeros(3, 8, dtype=torch.bfloat16), TypeError, "gates are"),
    (torch.zeros(3, 32, dtype=torch.float16), torch.zeros(3, 8, dtype=torch.float16), TypeError,
     "float32 or bfloat16"),
    (torch.zeros(3, 24), torch.zeros(3, 8), ValueError, "4x its last dim"),
    (torch.zeros(4, 32), torch.zeros(3, 8), ValueError, "4x its last dim"),
    (torch.zeros(0, 32), torch.zeros(0, 8), ValueError, "at least one element"),
    (torch.zeros(3, 32), torch.zeros(3, 8), ValueError, "runs on cpu or cuda"),
], ids=["dtypes differ", "float16", "gates width", "rows differ", "empty", "cpu tensors"])
def test_launch_refuses_what_the_kernels_do_not_take(gates, c, error, match):
    """The launch's checks, before any library is loaded: a CPU tensor given
    to the launch raises rather than taking the plain version."""
    with pytest.raises(error, match=match):
        G._launch(gates, c)


def test_tensors_on_another_device_are_refused():
    """Only CPU and CUDA tensors reach the op; others take the kernel's
    checks and raise."""
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        G.fused_lstm_gates(torch.zeros(3, 32, device="meta"), torch.zeros(3, 8, device="meta"))


def test_the_op_runs_the_plain_version_on_cpu():
    """The op ``satflow::fused_lstm_gates`` on CPU tensors is the plain
    version, bit for bit, in both dtypes."""
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        gates = (2 * torch.randn(5, 7, 4 * 12, generator=gen)).to(dtype)
        c = torch.randn(5, 7, 12, generator=gen).to(dtype)
        got = torch.ops.satflow.fused_lstm_gates(gates, c)
        for a, b in zip(got, G.fused_lstm_gates_ref(gates, c)):
            assert a.dtype == dtype and torch.equal(a, b)
