"""The routed experts of a mixture-of-experts layer on one card: the plan,
the CUDA kernels (``csrc/moe_experts.cu``) and their plain PyTorch
version.

Replaces no Pallas kernel. Without a mesh the JAX package computes every
expert on every token (``repro/models/moe.py``, ``moe_dense``), E / k
times the routed work. Here each (token, k) assignment gets one row of a
padded buffer, the experts' segments padded to the row tile ``bm``, and
the products run tile by tile on the tile's expert only, dropless:

  * ``routed_plan(idx, E)``: each assignment's row (its expert's segment
    start plus its rank among the assignments to that expert, in token
    then k order: ``models.moe.slot_ranks``' ranks with no capacity) and
    the tile table, each tile's expert or -1 past the last segment.
    Nothing is read on the host: the table's length ``tile_count(T*k, E)``
    depends on shapes alone, so the kernels' grids and buffers have fixed
    sizes and a CUDA graph captured once replays right as the routing
    changes.
  * ``moe_experts(x, rows, tiles, wg, wi, wo)``: the rows gathered into
    the padded buffer, ``h = silu(xp . wg[e]) * (xp . wi[e])`` (float32
    accumulators, silu and the product in float32, h rounded to x's
    dtype once) and ``y = h . wo[e]`` (float32 accumulators, rounded
    once). Returns y [tile_count * bm, D]; the padding rows hold
    whatever the buffers held, and nothing reads them.
  * ``moe_combine(y, rows, w)``: ``out[t] = sum_j bf16(w[t, j]) *
    y[row(t, j)]``, products and sums in float32 in j order, rounded
    once: the weights are cast to x's dtype first, as ``moe_dense``'s
    combine matrix is.

A CPU tensor takes ``routed_plan_plain``, ``moe_experts_plain`` and
``moe_combine_plain``, the same arithmetic in PyTorch (the products in
float32). A CUDA tensor launches the kernels or raises: bf16 operands,
D % 8 == F % 8 == 0, at most ``MAX_EXPERTS`` experts. On the ``meta``
device the wrappers check what the card's do, allocate what they allocate
and record the launch and its ``cost`` with the dry-run's counter. Each
wrapper counts one launch: ``moe_plan`` (count, scan, place),
``moe_experts`` (gather and both products), ``moe_combine``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import opcount
from repro_torch.kernels import Cost, aligned16, count_launch

MAX_EXPERTS = 1024  # the plan's scan: one block, a thread or more an expert


def row_tile(assignments: int, num_experts: int) -> int:
    """The kernels' row tile: 128 where the mean expert gets two tiles or
    more, else 64 (decode: less padding, more blocks)."""
    return 128 if assignments >= 2 * 128 * num_experts else 64


def tile_count(assignments: int, num_experts: int) -> int:
    """Tiles of the padded buffer: enough for any routing of
    ``assignments`` rows over ``num_experts`` experts, each segment padded
    to ``row_tile`` (at most ``E * (bm - 1)`` padding rows, and no tile
    without a routed row)."""
    bm = row_tile(assignments, num_experts)
    return min(assignments, (assignments + num_experts * (bm - 1)) // bm)


def routed_plan_plain(idx: torch.Tensor, num_experts: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows [T*k] int32, tiles [tile_count] int32) of the routing
    ``idx`` [T, k]: assignment ``t*k + j``'s row of the padded buffer, and
    each ``bm``-row tile's expert, -1 for the spare tiles. Counts by a
    scatter-add, ranks by ``models.moe.slot_ranks`` (stable: token order,
    then k), offsets by a cumulative sum of the padded counts."""
    from repro_torch.models.moe import slot_ranks
    flat = idx.reshape(-1)
    a, e, dev = flat.numel(), num_experts, idx.device
    bm = row_tile(a, e)
    counts = torch.zeros(e, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    padded = (counts + bm - 1) // bm * bm
    ends = padded.cumsum(0, dtype=torch.int32)
    rows = (ends - padded)[flat] + slot_ranks(idx, e).reshape(-1).int()
    first = torch.arange(tile_count(a, e), device=dev, dtype=torch.int32) * bm
    tiles = torch.searchsorted(ends, first, right=True).to(torch.int32)
    return rows, torch.where(tiles < e, tiles, -1)


def routed_plan(idx: torch.Tensor, num_experts: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``routed_plan_plain``'s rows and tiles; on the card three small
    kernels (each warp's counts, one block's scan, each row's place), the
    same integers."""
    if idx.device.type == "cpu":
        return routed_plan_plain(idx, num_experts)
    a, e = idx.numel(), num_experts
    if idx.dtype != torch.int64 or not idx.is_contiguous() \
            or idx.device.type not in ("cuda", "meta") \
            or not 0 < e <= MAX_EXPERTS:
        raise ValueError(f"moe_plan: idx {idx.dtype}{tuple(idx.shape)} on "
                         f"{idx.device}, {e} experts; the kernels take "
                         f"contiguous int64 on one CUDA device and at most "
                         f"{MAX_EXPERTS} experts")
    n = tile_count(a, e)
    rows = torch.empty(a, dtype=torch.int32, device=idx.device)
    tiles = torch.empty(n, dtype=torch.int32, device=idx.device)
    scratch = torch.empty((a + 31) // 32 * e, dtype=torch.int32,
                          device=idx.device)
    work = Cost(0, 8 * a + 4 * (a + n))
    if idx.device.type == "meta":
        opcount.kernel("moe_plan", *work)
        return rows, tiles
    from repro_torch.kernels import _build
    lib = _build.library("moe_experts")
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.moe_plan(
            idx.data_ptr(), rows.data_ptr(), tiles.data_ptr(),
            scratch.data_ptr(), a, e, row_tile(a, e), n, stream), "moe_plan")
    count_launch("moe_plan")
    opcount.kernel("moe_plan", *work)
    return rows, tiles


def cost(x: torch.Tensor, rows: torch.Tensor, wg: torch.Tensor) -> Cost:
    """One ``moe_experts`` call's routed work, from shapes: 6*D*F FLOPs a
    row routed (the padding rows the kernels also compute depend on the
    routing and are not counted); x and the weights read once, y's routed
    rows written once."""
    a, (e, d, f) = rows.numel(), wg.shape
    return Cost(6 * a * d * f,
                (x.numel() + 3 * e * d * f + a * d) * x.element_size())


def combine_cost(y: torch.Tensor, rows: torch.Tensor, t: int) -> Cost:
    """One ``moe_combine`` call: 2 FLOPs an element of each routed row,
    those rows read once, the [T, D] output written once."""
    a, d = rows.numel(), y.shape[1]
    return Cost(2 * a * d, (a * d + t * d) * y.element_size())


def moe_experts_plain(x: torch.Tensor, rows: torch.Tensor,
                      tiles: torch.Tensor, wg: torch.Tensor,
                      wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The kernels' arithmetic in PyTorch: x [T, D], rows [T*k], tiles,
    wg, wi [E, D, F], wo [E, F, D] → y [tiles * bm, D] in x's dtype, its
    padding rows zero. Each expert's run of tiles is one product in
    float32 (the tile table is read on the host)."""
    a, n = rows.numel(), tiles.numel()
    bm = row_tile(a, wg.shape[0])
    k = a // x.shape[0]
    xp = torch.zeros((n * bm, x.shape[1]), dtype=x.dtype, device=x.device)
    xp[rows.long()] = x.repeat_interleave(k, dim=0)
    y = torch.zeros_like(xp)
    ex = tiles.tolist()
    i = 0
    while i < n:
        j = i
        while j < n and ex[j] == ex[i]:
            j += 1
        if ex[i] >= 0:
            e, seg = ex[i], slice(i * bm, j * bm)
            xs = xp[seg].float()
            h = (F.silu(xs @ wg[e].float()) * (xs @ wi[e].float())).to(x.dtype)
            y[seg] = (h.float() @ wo[e].float()).to(x.dtype)
        i = j
    return y


def moe_combine_plain(y: torch.Tensor, rows: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """The combine in PyTorch: y [R, D], rows [T*k], w [T, k] float32 →
    [T, D] in y's dtype, the kernel's float32 products and sums in j
    order."""
    t, k = w.shape
    wk = w.to(y.dtype).float()
    got = y[rows.long()].view(t, k, -1).float()
    acc = torch.zeros_like(got[:, 0])
    for j in range(k):
        acc = acc + wk[:, j, None] * got[:, j]
    return acc.to(y.dtype)


def _check(x, rows, tiles, wg, wi, wo) -> None:
    what = "moe_experts"
    ts = (x, wg, wi, wo)
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise ValueError(f"{what}: dtypes {[t.dtype for t in ts]}; the "
                         f"kernels take bfloat16")
    if rows.dtype != torch.int32 or tiles.dtype != torch.int32:
        raise ValueError(f"{what}: rows and tiles must be int32, got "
                         f"{rows.dtype}, {tiles.dtype}")
    devs = {t.device for t in ts + (rows, tiles)}
    if len(devs) != 1 or x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{what}: operands on {sorted(map(str, devs))}; "
                         f"the kernels need one CUDA device")
    if x.dim() != 2 or wg.dim() != 3:
        raise ValueError(f"{what}: x{tuple(x.shape)}, wg{tuple(wg.shape)}")
    (t, d), (e, d2, f) = x.shape, wg.shape
    a = rows.numel()
    if d2 != d or wi.shape != wg.shape or wo.shape != (e, f, d) \
            or t == 0 or a % t or rows.dim() != 1 \
            or tiles.shape != (tile_count(a, e),):
        raise ValueError(f"{what}: x{tuple(x.shape)}, wg{tuple(wg.shape)}, "
                         f"wi{tuple(wi.shape)}, wo{tuple(wo.shape)}, rows"
                         f"{tuple(rows.shape)}, tiles{tuple(tiles.shape)}")
    if d % 8 or f % 8:
        raise ValueError(f"{what}: D={d}, F={f}; the kernels take "
                         f"D % 8 == F % 8 == 0")
    if not all(u.is_contiguous() and aligned16(u) for u in ts + (rows,)):
        raise ValueError(f"{what}: operands must be contiguous and 16-byte "
                         f"aligned")


def moe_experts(x: torch.Tensor, rows: torch.Tensor, tiles: torch.Tensor,
                wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor
                ) -> torch.Tensor:
    """x [T, D]; rows, tiles from ``routed_plan``; wg, wi [E, D, F], wo
    [E, F, D] → y [tiles * bm, D] in x's dtype, row ``rows[a]`` the
    SwiGLU experts' output of assignment a."""
    if x.device.type == "cpu":
        return moe_experts_plain(x, rows, tiles, wg, wi, wo)
    _check(x, rows, tiles, wg, wi, wo)
    (t, d), (e, _, f) = x.shape, wg.shape
    a, n = rows.numel(), tiles.numel()
    bm = row_tile(a, e)
    xp = torch.empty((n * bm, d), dtype=x.dtype, device=x.device)
    h = torch.empty((n * bm, f), dtype=x.dtype, device=x.device)
    y = torch.empty_like(xp)
    if x.device.type == "meta":
        opcount.kernel("moe_experts", *cost(x, rows, wg))
        return y
    from repro_torch.kernels import _build
    lib = _build.library("moe_experts")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.moe_experts_bf16(
            x.data_ptr(), rows.data_ptr(), tiles.data_ptr(), wg.data_ptr(),
            wi.data_ptr(), wo.data_ptr(), xp.data_ptr(), h.data_ptr(),
            y.data_ptr(), a, a // t, n, bm, e, d, f, stream), "moe_experts")
    count_launch("moe_experts")
    opcount.kernel("moe_experts", *cost(x, rows, wg))
    return y


def moe_combine(y: torch.Tensor, rows: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
    """y [R, D] from ``moe_experts``; rows [T*k]; w [T, k] float32 → [T, D]
    in y's dtype."""
    if y.device.type == "cpu":
        return moe_combine_plain(y, rows, w)
    t, k = w.shape
    d = y.shape[1]
    if y.dtype != torch.bfloat16 or w.dtype != torch.float32 \
            or rows.dtype != torch.int32 or rows.numel() != t * k \
            or d % 8 or len({y.device, rows.device, w.device}) != 1 \
            or not all(u.is_contiguous() and aligned16(u)
                       for u in (y, rows, w)):
        raise ValueError(f"moe_combine: y {y.dtype}{tuple(y.shape)}, rows "
                         f"{rows.dtype}{tuple(rows.shape)}, w {w.dtype}"
                         f"{tuple(w.shape)}: bf16 rows of D % 8 == 0, "
                         f"int32 rows, float32 weights, one device, "
                         f"contiguous and 16-byte aligned")
    out = torch.empty((t, d), dtype=y.dtype, device=y.device)
    if y.device.type == "meta":
        opcount.kernel("moe_combine", *combine_cost(y, rows, t))
        return out
    from repro_torch.kernels import _build
    lib = _build.library("moe_experts")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.moe_combine_bf16(
            y.data_ptr(), rows.data_ptr(), w.data_ptr(), out.data_ptr(), t,
            k, d, stream), "moe_combine")
    count_launch("moe_combine")
    opcount.kernel("moe_combine", *combine_cost(y, rows, t))
    return out
