"""Spatial (H-axis) parallelism of the ConvLSTM rollout, counterpart of
``satflow_tpu/parallel/spatial.py``.

Full-disk geometries (3712 px MSG frames) do not fit one card's rollout
activations. The image's rows are split over a mesh axis (``"model"`` by
default), M blocks of H/M rows, one per rank; the parameters are replicated.
Each ConvLSTM step:

1. exchanges one halo row of x and of h with the rank above and the rank
   below (:class:`HaloExchange`: ``batch_isend_irecv`` in the axis's group;
   the edge ranks receive zeros, which is the SAME conv's zero padding);
2. runs the port's fused step (K1 on the card; its backward K2, through
   ``FusedConvLSTMStep``) on the (B, H/M + 2, W, ·) halo-extended rows, c
   zero-padded by one row on each side;
3. keeps rows 1 .. H/M, whose 3x3 windows saw their true neighbours.

The step's kernel runs intact on each block. Unlike the JAX module, the
extended rows are not padded to a multiple of 8: those filler rows exist for
the Pallas kernel's row blocking, and K1 takes any height. The output head is
a 3x3 conv, VALID on H over the halo-extended rows and SAME on W
(``F.conv2d``, a library conv, as it is a plain XLA conv in JAX).

``torch.distributed`` has no differentiable send and receive, so the halo
exchange is an autograd Function whose backward sends each halo's
cotangent back to the rank that sent the row, which adds it into that edge
row: the transpose that ``ppermute`` gets for free. Every rank of the axis
runs the same graph, so the backward's exchanges meet in the same order.

In each process the rollout takes its rank's block of the batch
(:func:`local_block` of a global batch, or what
:func:`~satflow_tpu_torch.parallel.mesh.shard_batch` delivers inside a spatial
``mesh_scope``) and returns its block of the forecast; the batch rides the
``data`` axis where it divides. The parameters are the fused cells of a
:class:`~satflow_tpu_torch.models.conv_lstm.ConvLSTMCore`, whatever its remat
layout; the rollout keeps no remat, as in JAX.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from satflow_tpu_torch.ops.fused_convlstm_step import fused_convlstm_step
from satflow_tpu_torch.parallel.mesh import axis_size

Halos = Tuple[torch.Tensor, torch.Tensor]


class _Halo(torch.autograd.Function):
    """(B, Hl, W, C) block -> (the row above it, the row below it)."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, group, up: Optional[int], down: Optional[int]):
        ctx.group, ctx.up, ctx.down, ctx.shape = group, up, down, a.shape
        top = a.new_zeros(a[:, :1].shape)
        bot = a.new_zeros(a[:, :1].shape)
        ops = []
        if up is not None:  # my first row is the bottom halo of the rank above
            ops += [dist.P2POp(dist.isend, a[:, :1].contiguous(), up, group),
                    dist.P2POp(dist.irecv, top, up, group)]
        if down is not None:  # my last row is the top halo of the rank below
            ops += [dist.P2POp(dist.isend, a[:, -1:].contiguous(), down, group),
                    dist.P2POp(dist.irecv, bot, down, group)]
        _exchange(ops)
        return top, bot

    @staticmethod
    def backward(ctx, g_top: torch.Tensor, g_bot: torch.Tensor):
        grad = g_top.new_zeros(ctx.shape)
        from_up = g_top.new_zeros(g_top.shape)
        from_down = g_top.new_zeros(g_top.shape)
        ops = []
        if ctx.up is not None:  # my top halo was the upper rank's last row
            ops += [dist.P2POp(dist.isend, g_top.contiguous(), ctx.up, ctx.group),
                    dist.P2POp(dist.irecv, from_up, ctx.up, ctx.group)]
        if ctx.down is not None:
            ops += [dist.P2POp(dist.isend, g_bot.contiguous(), ctx.down, ctx.group),
                    dist.P2POp(dist.irecv, from_down, ctx.down, ctx.group)]
        _exchange(ops)
        grad[:, :1] += from_up  # the upper rank's bottom halo was my first row
        grad[:, -1:] += from_down
        return grad, None, None, None


def _exchange(ops: List) -> None:
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class HaloExchange:
    """The halo exchange over the ranks of ``group`` (an axis of the mesh),
    in rank order top to bottom: called on a (B, Hl, W, C) block, returns
    (the row above it, the row below it), zeros at the image's edges. A
    group of one rank exchanges nothing."""

    def __init__(self, group):
        self.group = group
        n, i = dist.get_world_size(group), dist.get_rank(group)
        self.up = dist.get_global_rank(group, i - 1) if i > 0 else None
        self.down = dist.get_global_rank(group, i + 1) if i < n - 1 else None

    def __call__(self, a: torch.Tensor) -> Halos:
        if self.up is None and self.down is None:
            zero = a.new_zeros(a[:, :1].shape)
            return zero, zero
        return _Halo.apply(a, self.group, self.up, self.down)


class WholeHalos:
    """The exchange of block ``index`` of ``parts`` of whole tensors that one
    process holds: what :class:`HaloExchange` delivers at that rank, cut
    from the tensors themselves (zeros at the image's edges). Its k-th call
    returns the halos of ``tensors[k]``, so :func:`_cell_step`, which
    exchanges x and then h, reads ``WholeHalos([x, h], i, m)``. Holds a
    block's step against the whole image's step without a process group."""

    def __init__(self, tensors: Sequence[torch.Tensor], index: int, parts: int):
        self.tensors, self.index, self.parts, self.calls = list(tensors), index, parts, 0

    def __call__(self, a: torch.Tensor) -> Halos:
        whole = self.tensors[self.calls]
        self.calls += 1
        hl = whole.shape[1] // self.parts
        lo, hi = self.index * hl, (self.index + 1) * hl
        zero = whole.new_zeros(whole[:, :1].shape)
        top = whole[:, lo - 1:lo] if self.index > 0 else zero
        bot = whole[:, hi:hi + 1] if self.index < self.parts - 1 else zero
        return top, bot


def _cell_step(x, h, c, cell, exchange: Callable[[torch.Tensor], Halos], dtype,
               step: Callable = fused_convlstm_step):
    """One fused ConvLSTM cell on a block of rows: exchange the halos of x and
    then of h, extend the block by them (c by zero rows), run ``step`` (K1 on
    the card) on the extended rows and keep rows 1 .. Hl. The two extended
    edge rows are computed on zero boundaries and dropped."""
    hl = x.shape[1]
    xt, xb = exchange(x)
    ht, hb = exchange(h)
    x_ext = torch.cat([xt, x, xb], dim=1).to(dtype)
    h_ext = torch.cat([ht, h, hb], dim=1).to(dtype)
    c_ext = F.pad(c, (0, 0, 0, 0, 1, 1)).to(dtype)
    h2, c2 = step(x_ext, h_ext, c_ext, cell.x_gates_kernel.to(dtype),
                  cell.h_gates_kernel.to(dtype), cell.bias.to(dtype))
    return h2[:, 1:hl + 1], c2[:, 1:hl + 1]


def _head_apply(h4, head, exchange, dtype) -> torch.Tensor:
    """The 3x3 output head on a block: VALID on H over the halo-extended
    rows, SAME on W."""
    t, b = exchange(h4)
    ext = torch.cat([t, h4, b], dim=1).permute(0, 3, 1, 2)
    y = F.conv2d(ext.to(dtype), head.weight.to(dtype), head.bias.to(dtype), padding=(0, 1))
    return y.permute(0, 2, 3, 1)


def _cells(core):
    """The four fused cells and the head of a ``ConvLSTMCore``; cells of
    another formulation raise, naming ``cell_impl='fused'``."""
    e1, e2 = core.encoder["encoder_1"], core.encoder["encoder_2"]
    d1, d2 = core.decoder["decoder_1"], core.decoder["decoder_2"]
    for cell in (e1, e2, d1, d2):
        if not hasattr(cell, "x_gates_kernel"):
            raise ValueError(
                "spatial parallelism reads fused-cell params "
                "(x_gates_kernel/h_gates_kernel/bias); got a "
                f"{type(cell).__name__} — build the model with cell_impl='fused'"
            )
    return e1, e2, d1, d2, core.decoder["head"]


def spatial_rollout(core, x: torch.Tensor, forecast_steps: int,
                    exchange: Callable[[torch.Tensor], Halos], dtype=None,
                    step: Callable = fused_convlstm_step) -> torch.Tensor:
    """The rollout of one block: (B, T, Hl, W, C) -> (B, steps, Hl, W, out),
    the two-cell encoder, the decoder fed its own h4, the head and the
    sigmoid; ``exchange`` gives each block's halos, ``step`` is the fused
    step (the plain version to compare against)."""
    e1, e2, d1, d2, head = _cells(core)
    bsz, frames, hl, w, _ = x.shape
    cdtype = dtype or x.dtype
    x = x.to(cdtype)
    z = x.new_zeros((bsz, hl, w, e1.features))
    h1 = c1 = h2 = c2 = z
    for t in range(frames):
        h1, c1 = _cell_step(x[:, t], h1, c1, e1, exchange, cdtype, step)
        h2, c2 = _cell_step(h1, h2, c2, e2, exchange, cdtype, step)
    h3 = c3 = h4 = c4 = z
    v = h2
    outs = []
    for _ in range(forecast_steps):
        h3, c3 = _cell_step(v, h3, c3, d1, exchange, cdtype, step)
        h4, c4 = _cell_step(h3, h4, c4, d2, exchange, cdtype, step)
        outs.append(_head_apply(h4, head, exchange, cdtype))
        v = h4
    return torch.sigmoid(torch.stack(outs, dim=1))


def _batch_rides_data(b: int, mesh, axis: str) -> bool:
    names = mesh.mesh_dim_names
    return "data" in names and axis != "data" and b % axis_size(mesh, "data") == 0


def local_block(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """This rank's block of a global (B, T, H, W, C) batch: H/M rows over
    ``axis`` (an H that does not divide raises), and B/D over ``data`` where
    it divides (else every data rank holds the whole batch)."""
    n = axis_size(mesh, axis)
    if x.shape[2] % n:
        raise ValueError(f"H={x.shape[2]} must divide by the {axis!r} axis size {n}")
    if _batch_rides_data(x.shape[0], mesh, axis):
        bl = x.shape[0] // axis_size(mesh, "data")
        x = x.narrow(0, mesh.get_local_rank("data") * bl, bl)
    hl = x.shape[2] // n
    return x.narrow(2, mesh.get_local_rank(axis) * hl, hl)


def convlstm_spatial_forward(core, x: torch.Tensor, forecast_steps: int, mesh,
                             axis: str = "model", dtype=None,
                             step: Callable = fused_convlstm_step) -> torch.Tensor:
    """H-sharded ConvLSTM rollout of a global batch (the same on every rank,
    as each JAX process passes the same host value): (B, T, H, W, C) ->
    this rank's block (B or B/D, steps, H/M, W, out) of the forecast.
    ``core`` is a fused-cell ``ConvLSTMCore``; H must divide by the axis
    size."""
    block = local_block(x, mesh, axis)
    return spatial_rollout(core, block, forecast_steps, HaloExchange(mesh.get_group(axis)),
                           dtype=dtype, step=step)
