"""Public SpMM ops: host preparation of a static graph (``prepare_tiles``,
once per graph), the binding of its edges (``TilePrep.with_edges``, once
per graph and src), and the destination-sorted segment sum, with the
gather of ``spmm`` fused into the kernel.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain torch version in ``ref.py``.  Nothing falls
back from the kernel to the plain version, and a prep on another device
than the rows raises: there is no host-to-device copy per call.

Routes (``route``): ``spmm`` takes ``bound`` when the prep's edges were
bound from the very ``src`` and ``weights`` it is handed, unchanged since,
for ``x``'s row count; it reads them in destination order.  Otherwise, and
for ``segment_sum_tiles``, it takes ``perm``, which gathers them through
the destination order on each call.  Both are kernels on the card; on the
CPU each has its plain version.
"""
from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from .. import LaunchCounter
from . import kernel
from .ref import segment_sum_ref, sorted_sum_ref, spmm_ref

#: the kernel's routes: edges bound in destination order, or gathered
#: through ``perm`` on each call
ROUTES = ("bound", "perm")


class RouteCounter(LaunchCounter):
    """Launches in all (``count``) and by route (``by_route``)."""

    def __init__(self):
        super().__init__()
        self.by_route = dict.fromkeys(ROUTES, 0)

    def reset(self) -> None:
        super().reset()
        self.by_route = dict.fromkeys(ROUTES, 0)

    def add(self, route: str) -> None:
        with self._lock:
            self.count += 1
            self.by_route[route] += 1


launches = RouteCounter()

#: a row with more in-edges than this is summed by several warps, one per
#: chunk of this many edges (``csrc/spmm.cu``)
SPLIT_EDGES = 1024

_INT32_MAX = 2**31 - 1


def _mark(t: torch.Tensor | None) -> tuple:
    """What identifies ``t`` as it is now: the object (weakly) and its
    in-place version."""
    return (None, None) if t is None else (weakref.ref(t), t._version)


@dataclass(frozen=True, eq=False)
class BoundEdges:
    """A graph's ``src`` and ``weights`` in destination order, and the
    tensors they were built from (``TilePrep.with_edges``)."""
    src: torch.Tensor               # (E,) wrap_clamp_index(src, num_rows)
                                    # [perm]; int32 below 2^31 rows
    weights: torch.Tensor | None    # (E,) float32 weights[perm], or None
    num_rows: int                   # the x row count the clamp was for
    marks: tuple                    # _mark(src), _mark(weights)

    def built_from(self, src, weights, num_rows: int) -> bool:
        """True when ``src`` and ``weights`` are the very tensors these
        were built from, unchanged since, and ``num_rows`` is theirs."""
        if num_rows != self.num_rows:
            return False
        for t, (ref, version) in zip((src, weights), self.marks):
            if (t is None) != (ref is None):
                return False
            if t is not None and (ref() is not t or t._version != version):
                return False
        return True

    def to(self, device) -> "BoundEdges":
        return dataclasses.replace(
            self, src=self.src.to(device),
            weights=None if self.weights is None
            else self.weights.to(device))


@dataclass(frozen=True, eq=False)
class TilePrep:
    """One graph's destination order, as tensors on one device.

    The reference's TPU tiling (128-edge tiles, padded blocks, -1 pad
    rows) exists for its MXU one-hot matmul and is not carried over.
    ``perm`` is exactly the reference's ``order``; ``hub_rows`` and
    ``hub_chunk_ptr`` follow from ``row_ptr`` and ``split``."""
    perm: torch.Tensor           # (E,) stable argsort of dst; int32 below 2^31
    row_ptr: torch.Tensor        # (N + 1,) int64: node i's edges are
                                 # perm[row_ptr[i]:row_ptr[i + 1]]
    num_nodes: int
    split: int                   # 0: no row is cut into chunks
    hub_rows: torch.Tensor       # (H,) int64 rows with more than split edges
    hub_chunk_ptr: torch.Tensor  # (H + 1,) int64 offsets of their chunks
    n_chunks: int
    blocks: torch.Tensor         # (B + 1,) int64 first rows of the bound
                                 # route's row blocks (kernel.row_blocks)
    edges: BoundEdges | None = None  # src and weights bound by with_edges

    @property
    def num_edges(self) -> int:
        return int(self.perm.numel())

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def to(self, device) -> "TilePrep":
        """The same prep with its arrays on ``device``."""
        return dataclasses.replace(
            self, perm=self.perm.to(device), row_ptr=self.row_ptr.to(device),
            hub_rows=self.hub_rows.to(device),
            hub_chunk_ptr=self.hub_chunk_ptr.to(device),
            blocks=self.blocks.to(device),
            edges=None if self.edges is None else self.edges.to(device))

    def with_edges(self, src, weights=None, *, num_rows: int) -> "TilePrep":
        """The same prep with ``src`` (and ``weights``) stored in
        destination order, on the prep's device: ``spmm`` reads them there
        when it is handed these very tensors, unchanged (an in-place edit
        bumps ``._version``), and an ``x`` of ``num_rows`` rows; any other
        call takes the ``perm`` route.  ``src`` follows JAX's
        wrap-then-clamp rule for ``num_rows``, applied here once.  Once per
        graph, like ``prepare_tiles``; ``to()`` and ``with_split()`` keep
        the bound arrays."""
        num_rows = int(num_rows)
        if num_rows < 0:
            raise ValueError(f"with_edges: num_rows {num_rows} is negative")
        if self.num_edges > _INT32_MAX:
            raise ValueError(f"with_edges: {self.num_edges} edges; the bound "
                             f"route takes at most 2^31 - 1")
        for name, t in (("src", src), ("weights", weights)):
            if t is None:
                continue
            if t.device != self.device:
                raise ValueError(f"with_edges: {name} is on {t.device}, the "
                                 f"prep on {self.device}")
            if tuple(t.shape) != (self.num_edges,):
                raise ValueError(f"with_edges: {name} has shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"({self.num_edges},)")
        if src is None or src.dtype not in kernel.INDEX_DTYPES:
            raise TypeError("with_edges: src must be an int32 or int64 "
                            "tensor")
        if weights is not None and not weights.is_floating_point():
            raise TypeError(f"with_edges: weights have dtype "
                            f"{weights.dtype}")
        # wrap_clamp_index(src, num_rows)[perm], gathered first so that no
        # (E,) int64 copy is made for an int32 src
        wide = num_rows > _INT32_MAX
        g = src[self.perm].to(torch.int64 if wide else src.dtype)
        g = torch.where(g < 0, g + num_rows, g).clamp_(0, max(num_rows - 1,
                                                               0))
        edges = BoundEdges(
            src=g.to(torch.int64 if wide else torch.int32),
            weights=None if weights is None else weights.float()[self.perm],
            num_rows=num_rows, marks=(_mark(src), _mark(weights)))
        return dataclasses.replace(self, edges=edges)

    def with_split(self, split: int | None) -> "TilePrep":
        """The same order with rows cut at ``split`` edges (None: never;
        ``chip_smoke.py`` times the kernel both ways)."""
        split = int(split or 0)
        if split < 0:
            raise ValueError(f"spmm: split {split} is negative")
        counts = self.row_ptr[1:] - self.row_ptr[:-1]
        hubs = (torch.nonzero(counts > split).flatten() if split
                else counts.new_zeros(0))
        chunks = (counts[hubs] + split - 1) // max(split, 1)
        ptr = torch.cat([chunks.new_zeros(1), torch.cumsum(chunks, 0)])
        return dataclasses.replace(self, split=split, hub_rows=hubs,
                                   hub_chunk_ptr=ptr,
                                   n_chunks=int(ptr[-1]))

    def dst(self) -> torch.Tensor:
        """(E,) int64 destination of every edge, in the original order."""
        counts = self.row_ptr[1:] - self.row_ptr[:-1]
        nodes = torch.arange(self.num_nodes, device=self.device)
        out = torch.empty(self.num_edges, dtype=torch.int64,
                          device=self.device)
        out[self.perm.long()] = torch.repeat_interleave(nodes, counts)
        return out


def prepare_tiles(dst, num_nodes: int) -> TilePrep:
    """Host preparation, once per static graph: ``dst`` (E,) integer node
    ids in [0, num_nodes), numpy or a CPU tensor.  Returns a ``TilePrep``
    on the CPU, rows cut at ``SPLIT_EDGES``; ``.to(device)`` moves it
    once."""
    dst = np.asarray(dst)
    if dst.ndim != 1 or not np.issubdtype(dst.dtype, np.integer):
        raise TypeError(f"spmm: dst must be a 1-d integer array, got "
                        f"{dst.dtype} of shape {dst.shape}")
    num_nodes = int(num_nodes)
    if num_nodes < 0:
        raise ValueError(f"spmm: num_nodes {num_nodes} is negative")
    if len(dst) and (int(dst.min()) < 0 or int(dst.max()) >= num_nodes):
        raise ValueError(f"spmm: dst holds ids outside [0, {num_nodes}): "
                         f"[{int(dst.min())}, {int(dst.max())}]")
    order = np.argsort(dst, kind="stable")
    row_ptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=row_ptr[1:])
    perm = order.astype(np.int32 if len(dst) <= _INT32_MAX else np.int64)
    row_ptr = torch.from_numpy(row_ptr)
    prep = TilePrep(perm=torch.from_numpy(perm), row_ptr=row_ptr,
                    num_nodes=num_nodes, split=0,
                    hub_rows=torch.zeros(0, dtype=torch.int64),
                    hub_chunk_ptr=torch.zeros(1, dtype=torch.int64),
                    n_chunks=0, blocks=kernel.row_blocks(row_ptr))
    return prep.with_split(SPLIT_EDGES)


def _check(what, rows, src, weights, prep):
    if not isinstance(prep, TilePrep):
        raise TypeError(f"{what}: prep must be a TilePrep")
    if prep.device != rows.device:
        raise ValueError(f"{what}: prep is on {prep.device}, the rows on "
                         f"{rows.device}; move it once with prep.to()")
    if rows.dim() != 2:
        raise ValueError(f"{what}: rows must be 2-d, got "
                         f"{tuple(rows.shape)}")
    E = prep.num_edges
    for name, t in (("src", src), ("weights", weights)):
        if t is None:
            continue
        if t.device != rows.device:
            raise ValueError(f"{what}: {name} is on {t.device}, the rows "
                             f"on {rows.device}")
        if tuple(t.shape) != (E,):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected ({E},)")
    if src is not None and src.dtype not in kernel.INDEX_DTYPES:
        raise TypeError(f"{what}: src has dtype {src.dtype}, expected "
                        f"int32 or int64")
    if weights is not None and not weights.is_floating_point():
        raise TypeError(f"{what}: weights have dtype {weights.dtype}")


def route(x, src, weights, prep: TilePrep) -> str:
    """The route ``spmm(x, src, weights, prep)`` takes (see the module
    docstring)."""
    e = prep.edges
    return ("bound" if e is not None
            and e.built_from(src, weights, int(x.shape[0])) else "perm")


def _launch(rows, src, weights, prep, out_dtype, what, route="perm"):
    """The kernel on a CUDA tensor: checks, allocates Y, launches once on
    ``route`` (``bound``: ``src`` and ``weights`` are in destination
    order)."""
    if rows.dtype not in kernel.DTYPES or out_dtype not in kernel.DTYPES:
        raise TypeError(f"{what}: dtype {rows.dtype} -> {out_dtype} (the "
                        f"kernel takes float32 or bf16 rows)")
    if not rows.is_contiguous():
        raise ValueError(f"{what}: rows are not contiguous")
    N, D = prep.num_nodes, rows.shape[1]
    if N + prep.n_chunks > 8 * _INT32_MAX:
        raise ValueError(f"{what}: {N} nodes beyond the kernel's grid")
    if prep.num_edges and rows.shape[0] == 0:
        raise ValueError(f"{what}: edges gather from an empty x")
    if src is not None:
        src = src.contiguous()
    if weights is not None:
        weights = weights.float().contiguous()
    out = torch.empty((N, D), dtype=out_dtype, device=rows.device)
    if out.numel() == 0:
        return out
    if route == "bound":
        kernel.launch_bound(rows, src, weights, prep, blocks=prep.blocks,
                            out=out)
    else:
        kernel.launch(rows, src, weights, prep, out=out)
    launches.add(route)
    return out


def segment_sum_tiles(messages, prep: TilePrep):
    """messages: (E, D) in original edge order -> (num_nodes, D):
    ``Y[dst] += messages``, on the ``perm`` route (the bound route's kernel
    with ``perm`` as the row ids ran slower at D = 70; ``chip_smoke.py``
    times both)."""
    _check("segment_sum_tiles", messages, None, None, prep)
    if messages.shape[0] != prep.num_edges:
        raise ValueError(f"segment_sum_tiles: {messages.shape[0]} messages "
                         f"for {prep.num_edges} edges")
    if messages.device.type != "cuda":
        return segment_sum_ref(messages, prep.dst(), prep.num_nodes)
    return _launch(messages, None, None, prep, messages.dtype,
                   "segment_sum_tiles")


def spmm(x, src, weights, prep: TilePrep):
    """Y[dst] += w * X[src] (``src`` with JAX's wrap-then-clamp rule),
    without materialising the (E, D) messages.  The output's dtype is the
    messages' (``x``'s, promoted with ``weights``'), as in the reference.
    Reads ``prep``'s bound edges when ``route`` says so."""
    _check("spmm", x, src, weights, prep)
    if src is None:
        raise ValueError("spmm: src is required")
    bound = route(x, src, weights, prep) == "bound"
    e = prep.edges
    if x.device.type != "cuda":
        if bound:
            return sorted_sum_ref(
                x, e.src, None if weights is None
                else e.weights.to(weights.dtype), prep.row_ptr)
        return spmm_ref(x, src, prep.dst(), weights, prep.num_nodes)
    out_dtype = (x.dtype if weights is None
                 else torch.promote_types(x.dtype, weights.dtype))
    if bound:
        return _launch(x, e.src, e.weights, prep, out_dtype, "spmm", "bound")
    return _launch(x, src, weights, prep, out_dtype, "spmm")
