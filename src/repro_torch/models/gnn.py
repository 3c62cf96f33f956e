"""GNN substrate of the port: GIN, GatedGCN, EGNN and NequIP-lite, the
counterparts of ``repro.models.gnn``.

Graph batches are dicts of tensors with masks, as in the reference, so
every model works unmodified for one big graph, a padded batch of small
molecule graphs (``graph_ids`` routes the readout) and sampled subgraphs:

  nodes (N, F) · edges (E, 2) int32 · edge_attr (E, Fe)|None · coords (N,3)|None
  node_mask (N,) · edge_mask (E,) · graph_ids (N,) int32

Every segment sum of the reference (``jax.ops.segment_sum`` over ``dst``,
and the readout over ``graph_ids``) goes through the ``spmm`` kernel
(``kernels/spmm``): GIN's ``h[src] * edge_mask`` through ``spmm`` on the
edges bound once per batch (``neighbour_sum``), per-edge messages through
``segment_sum_tiles`` (``segment_sum``).  A batch's destination order is
prepared once on the host (``graph_prep``, or ``edge_prep`` without a
readout) and passed down, so an L-layer
forward prepares it once, not L times.  On the card each sum is one launch
with one fixed order of summation; on the CPU the ops take their plain
versions.  Gathers follow JAX's index rule (``wrap_clamp_index``).

On a ``DeviceMesh`` (``launch.steps.make_gnn_train_step`` on DTensors:
parameters replicated, the batch placed by ``dist.sharding.gnn_batch_specs``,
node and edge leaves split on their rows over the data axes where they
divide them) each rank runs the model on its local rows, as ``MeshRows``
lays them out: the node-wise products on its node rows, the edge terms on
its edge rows (one ``TilePrep`` per rank), the node tensors edge work
reads gathered whole, each segment sum over its own edges sent to the
node rows' layout by a fixed-order sum over the ranks, and the batch-norm
statistics, readouts and losses summed over all ranks' rows.  A replicated
leaf is computed whole on every rank and summed once.

NequIP-lite keeps the reference's l<=2 feature algebra in the Cartesian
basis (scalars / vectors / traceless symmetric matrices), every coupling
path an einsum.  ``torch.Generator`` cannot reproduce ``jax.random``, so
``params_from_reference`` carries the reference's weights over for parity.
Under autograd every segment sum's backward is ``spmm`` too (a gather for
``segment_sum_tiles``; ``spmm`` over the reversed edges for
``neighbour_sum``, prepared once with ``graph_prep(..., reverse=True)``);
the gathers by ``src_rows``/``dst_rows`` are torch indexing, whose backward
(``index_put_`` with accumulation) sends a clamped row its gradient where
JAX drops it, which matters only for ids outside [0, N).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..dist import sharding as SH
from ..kernels import wrap_clamp_index
from ..kernels.spmm import (TilePrep, abstract_tiles, prepare_tiles,
                            segment_sum_tiles, spmm)
from . import layers as L


# ===========================================================================
# a batch's rows on a mesh
# ===========================================================================

@dataclass(frozen=True, eq=False)
class MeshRows:
    """A GNN batch's layout on a ``DeviceMesh``: node leaves split by rows
    over mesh dims ``nodes`` (() when whole on every rank), edge leaves
    over ``edges``; the parameters whole.  Every function is the identity
    where nothing is split (``ONE_DEVICE``), so one device runs the
    unsharded model unchanged.  A tensor is either split as its leaves are
    or whole, and its gradient follows it (``dist.sharding``)."""
    mesh: object = None
    nodes: tuple = ()
    edges: tuple = ()

    def for_edges(self, h):
        """Node rows ``h`` whole, for the edge terms to gather from."""
        if self.nodes:
            return SH.gather_rows(h, self.mesh, self.nodes,
                                  partial_grad=bool(self.edges))
        return SH.sum_grads(h, self.mesh, self.edges)

    def to_nodes(self, s):
        """Every node's sum over this rank's edges (N, ...) in the node
        rows' layout: summed over the ranks where the edges are split (a
        replicated edge set is summed once, on every rank)."""
        if self.edges:
            if self.nodes:
                return SH.sum_into_rows(s, self.mesh, self.edges)
            return SH.sum_over(s, self.mesh, self.edges)
        if self.nodes:
            return SH.own_rows(SH.sum_grads(s, self.mesh, self.nodes),
                               self.mesh, self.nodes)
        return s

    def node_total(self, x):
        """A sum over this rank's node rows, summed over all ranks' (a
        readout's or a loss's, read whole)."""
        return SH.sum_over(x, self.mesh, self.nodes)

    def node_stat(self, x):
        """``node_total`` of a statistic that each rank's own rows read
        back (a batch norm's mean and variance): its gradient is summed
        over the ranks too."""
        return SH.sum_grads(SH.sum_over(x, self.mesh, self.nodes),
                            self.mesh, self.nodes)

    def edge_stat(self, x):
        """``node_stat`` over edge rows."""
        return SH.sum_grads(SH.sum_over(x, self.mesh, self.edges),
                            self.mesh, self.edges)

    def views(self, params):
        """(the parameters as node-wise work reads them, as edge-wise work
        does): each gradient summed over the dims that split its rows."""
        return (_tree_map(lambda t: SH.sum_grads(t, self.mesh, self.nodes),
                          params),
                _tree_map(lambda t: SH.sum_grads(t, self.mesh, self.edges),
                          params))


ONE_DEVICE = MeshRows()


def mesh_rows(batch) -> MeshRows:
    """The ``MeshRows`` of a batch of DTensor leaves placed by
    ``gnn_batch_specs`` (``ONE_DEVICE`` for plain tensors)."""
    x = batch["node_mask"]
    if not SH.is_dtensor(x):
        return ONE_DEVICE
    return MeshRows(x.device_mesh, SH.split_dims(x),
                    SH.split_dims(batch["edge_mask"]))


# ===========================================================================
# a batch's destination order, prepared once per batch
# ===========================================================================

@dataclass(frozen=True, eq=False)
class GraphPrep:
    """One batch's edges and segment orders on the batch's device.

    ``edges`` is the ``TilePrep`` of ``dst`` with ``src`` and ``edge_mask``
    bound (``TilePrep.with_edges``), so ``neighbour_sum`` takes the
    kernel's ``bound`` route on these very tensors; ``graphs`` the
    ``TilePrep`` of ``graph_ids`` (None when the forward has no readout).
    ``src_rows`` and ``dst_rows`` are the endpoints under JAX's gather
    rule for the ``num_nodes`` rows, made at first use.  On a mesh the
    edges are this rank's, over all ``num_nodes`` nodes, and ``graphs``
    this rank's node rows' (``rows`` their layout)."""
    src: torch.Tensor
    dst: torch.Tensor
    edge_mask: torch.Tensor
    num_nodes: int
    edges: TilePrep
    n_graphs: int = 0
    graphs: TilePrep | None = None
    rows: MeshRows = ONE_DEVICE

    @functools.cached_property
    def src_rows(self) -> torch.Tensor:
        return wrap_clamp_index(self.src, self.num_nodes)

    @functools.cached_property
    def dst_rows(self) -> torch.Tensor:
        return wrap_clamp_index(self.dst, self.num_nodes)


def segments(ids, n: int, device, *, abstract: bool = False) -> TilePrep:
    """The ``TilePrep`` of segment ``ids`` (numpy or a tensor) over ``n``
    segments on ``device``, prepared on the host.  JAX's segment sum drops
    an id outside [0, n); here such ids go to one extra segment ``n``,
    which ``segment_sum`` and ``neighbour_sum`` cut off.  With ``abstract``
    no id is read: ``abstract_tiles`` of ``len(ids)`` ids over ``n``
    segments (a shape-only trace's)."""
    if abstract:
        return abstract_tiles(len(ids), n, device)
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    ids = np.asarray(ids)
    if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= n):
        ids, n = np.where((ids < 0) | (ids >= n), n, ids), n + 1
    return prepare_tiles(ids, n).to(device)


def edge_prep(edges: torch.Tensor, edge_mask: torch.Tensor,
              num_nodes: int, *, reverse: bool = False,
              abstract: bool = False) -> GraphPrep:
    """The ``GraphPrep`` of an (E, 2) edge tensor over ``num_nodes`` nodes,
    without a readout: ``segments`` of ``dst``, ``src`` and ``edge_mask``
    bound, and with ``reverse`` their reverse (``neighbour_sum``'s
    backward; a second host preparation).  ``abstract``: shapes only
    (``segments``, ``TilePrep.with_abstract_reverse``)."""
    src, dst = edges[:, 0], edges[:, 1]
    prep = segments(dst, num_nodes, edges.device,
                    abstract=abstract).with_edges(src, edge_mask,
                                                  num_rows=num_nodes)
    if reverse:
        prep = (prep.with_abstract_reverse() if abstract
                else prep.with_reverse(src))
    return GraphPrep(src=src, dst=dst, edge_mask=edge_mask,
                     num_nodes=num_nodes, edges=prep)


def graph_prep(batch: dict, n_graphs: int = 1, *,
               reverse: bool = False, abstract: bool = False) -> GraphPrep:
    """The ``GraphPrep`` of a batch: its edges over ``node_mask``'s N nodes
    and its readout over ``graph_ids`` into ``n_graphs`` graphs (with
    ``reverse``, the bound edges' reverse too: a train step's).  A batch
    of DTensors (``gnn_batch_specs``) gets this rank's: its edge rows over
    all N nodes, its node rows' readout, and their ``MeshRows``.  With
    ``abstract`` no id is read and every tensor is made empty, of the
    shape a real preparation gives when no row has more than
    ``kernels.spmm.SPLIT_EDGES`` edges, every id is in range and the
    degrees are uniform (``kernels.spmm.abstract_tiles``): under
    ``FakeTensorMode``, the shape-only preparation of ``launch.dryrun``."""
    rows = mesh_rows(batch)
    num_nodes = int(batch["node_mask"].shape[0])
    batch = {k: SH.local_value(batch[k])
             for k in ("edges", "edge_mask", "graph_ids")}
    gp = edge_prep(batch["edges"], batch["edge_mask"], num_nodes,
                   reverse=reverse, abstract=abstract)
    return dataclasses.replace(
        gp, n_graphs=n_graphs, rows=rows,
        graphs=segments(batch["graph_ids"], n_graphs,
                        batch["graph_ids"].device, abstract=abstract))


def segment_sum(data: torch.Tensor, prep: TilePrep, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(data, ids, num_segments=n)`` for the ids of
    ``prep`` (``segments``): ``data`` (E, ...) summed in float32 by
    ``segment_sum_tiles`` into (n, ...), in ``data``'s dtype."""
    flat = data.reshape(data.shape[0], math.prod(data.shape[1:]))
    out = segment_sum_tiles(flat.float().contiguous(), prep)[:n]
    return out.reshape((n,) + tuple(data.shape[1:])).to(data.dtype)


def neighbour_sum(h: torch.Tensor, gp: GraphPrep) -> torch.Tensor:
    """``segment_sum(h[src] * edge_mask, dst, N)`` without the (E, D)
    messages: one ``spmm`` on the edges bound in ``gp`` (on a mesh, of
    this rank's node rows ``h``, into them)."""
    h = gp.rows.for_edges(h)
    return gp.rows.to_nodes(spmm(h.contiguous(), gp.src, gp.edge_mask,
                                 gp.edges)[:gp.num_nodes])


def _edge_sum(data: torch.Tensor, gp: GraphPrep) -> torch.Tensor:
    return gp.rows.to_nodes(segment_sum(data, gp.edges, gp.num_nodes))


def _readout(h: torch.Tensor, node_mask: torch.Tensor,
             gp: GraphPrep) -> torch.Tensor:
    mask = node_mask.reshape(node_mask.shape + (1,) * (h.dim() - 1))
    return gp.rows.node_total(segment_sum(h * mask, gp.graphs, gp.n_graphs))


# ===========================================================================
# shared pieces
# ===========================================================================

def _masked_batchnorm(x, mask, eps=1e-5, total=ONE_DEVICE.node_stat):
    """Training-mode batch norm statistics over valid nodes (no running
    stats; the benchmark GNNs recompute per step); ``total`` sums a sum
    over this rank's rows over all ranks' (``MeshRows.node_stat`` or
    ``edge_stat``)."""
    m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
    denom = torch.clamp_min(total(m.sum()), 1.0)
    mu = total((x * m).sum(dim=0, keepdim=True)) / denom
    var = total((torch.square(x - mu) * m).sum(dim=0, keepdim=True)) / denom
    return (x - mu) * torch.rsqrt(var + eps) * m


def _mlp2_init(generator, d_in, d_h, d_out, dtype):
    return {"l1": L.dense_init(generator, d_in, d_h, bias=True, dtype=dtype),
            "l2": L.dense_init(generator, d_h, d_out, bias=True,
                               dtype=dtype)}


def _mlp2(p, x, act="silu"):
    return L.dense(p["l2"], L.activation(act, L.dense(p["l1"], x)))


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _on_rows(params, batch):
    """The parameters and the batch as this rank's plain tensors: each
    DTensor parameter whole (``SH.whole_local``), each DTensor batch leaf
    its local rows; plain tensors pass through."""
    if not SH.is_dtensor(batch["node_mask"]):
        return params, batch
    return (_tree_map(SH.whole_local, params),
            {k: SH.local_value(v) for k, v in batch.items()})


# ===========================================================================
# GIN  (Xu et al., arXiv:1810.00826) — 5L, d=64, sum agg, learnable eps
# ===========================================================================

@dataclass(frozen=True)
class GINConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 0            # input feature dim (required)
    n_classes: int = 2
    dtype: str = "float32"


def gin_init(cfg: GINConfig, generator: torch.Generator) -> dict:
    dt, dev = _dtype(cfg), generator.device
    layers = [{"mlp": _mlp2_init(generator, cfg.d_hidden, cfg.d_hidden,
                                 cfg.d_hidden, dt),
               "eps": torch.zeros((), dtype=dt, device=dev)}
              for _ in range(cfg.n_layers)]
    return {"encoder": L.dense_init(generator, cfg.d_in, cfg.d_hidden,
                                    bias=True, dtype=dt),
            "layers": layers,
            "head": L.dense_init(generator, cfg.d_hidden, cfg.n_classes,
                                 bias=True, dtype=dt)}


def gin_apply(cfg: GINConfig, params, batch, *, n_graphs: int = 1,
              prep: GraphPrep | None = None):
    gp = prep or graph_prep(batch, n_graphs)
    params, batch = _on_rows(params, batch)
    pn, _ = gp.rows.views(params)
    h = L.dense(pn["encoder"], batch["nodes"])
    for lp in pn["layers"]:
        agg = neighbour_sum(h, gp)
        h = _mlp2(lp["mlp"], (1.0 + lp["eps"]) * h + agg, act="relu")
        h = _masked_batchnorm(h, batch["node_mask"], total=gp.rows.node_stat)
        h = F.relu(h)
    node_logits = L.dense(pn["head"], h)
    graph_repr = _readout(h, batch["node_mask"], gp)
    return {"node_logits": node_logits,
            "graph_logits": L.dense(params["head"], graph_repr),
            "node_repr": h}


# ===========================================================================
# GatedGCN  (Bresson & Laurent; benchmarking-gnns arXiv:2003.00982)
# 16L, d=70, gated edge aggregation, residual, BN
# ===========================================================================

@dataclass(frozen=True)
class GatedGCNConfig:
    name: str
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 0
    d_edge_in: int = 0       # 0 -> edges start from ones
    n_classes: int = 2
    dtype: str = "float32"


def gatedgcn_init(cfg: GatedGCNConfig, generator: torch.Generator) -> dict:
    dt, d = _dtype(cfg), cfg.d_hidden
    layers = [{k: L.dense_init(generator, d, d, bias=True, dtype=dt)
               for k in ("U", "V", "A", "B", "C")}
              for _ in range(cfg.n_layers)]
    return {"encoder": L.dense_init(generator, cfg.d_in, d, bias=True,
                                    dtype=dt),
            "edge_encoder": L.dense_init(generator, max(cfg.d_edge_in, 1), d,
                                         bias=True, dtype=dt),
            "layers": layers,
            "head": L.dense_init(generator, d, cfg.n_classes, bias=True,
                                 dtype=dt)}


def gatedgcn_apply(cfg: GatedGCNConfig, params, batch, *, n_graphs: int = 1,
                   prep: GraphPrep | None = None):
    gp = prep or graph_prep(batch, n_graphs)
    params, batch = _on_rows(params, batch)
    pn, pe = gp.rows.views(params)
    src, dst, whole = gp.src_rows, gp.dst_rows, gp.rows.for_edges
    emask = batch["edge_mask"][:, None]
    h = L.dense(pn["encoder"], batch["nodes"])
    ea = batch.get("edge_attr")
    if ea is None:
        ea = torch.ones((batch["edges"].shape[0], 1), dtype=h.dtype,
                        device=h.device)
    e = L.dense(pe["edge_encoder"], ea)
    for lp, lpe in zip(pn["layers"], pe["layers"]):
        e_new = (whole(L.dense(lp["A"], h))[src]
                 + whole(L.dense(lp["B"], h))[dst] + L.dense(lpe["C"], e))
        eta = torch.sigmoid(e_new) * emask
        num = _edge_sum(eta * whole(L.dense(lp["V"], h))[src], gp)
        den = _edge_sum(eta, gp) + 1e-6
        h_new = L.dense(lp["U"], h) + num / den
        h = h + F.relu(_masked_batchnorm(h_new, batch["node_mask"],
                                         total=gp.rows.node_stat))
        e = e + F.relu(_masked_batchnorm(e_new, batch["edge_mask"],
                                         total=gp.rows.edge_stat))
    graph_repr = _readout(h, batch["node_mask"], gp)
    return {"node_logits": L.dense(pn["head"], h),
            "graph_logits": L.dense(params["head"], graph_repr),
            "node_repr": h}


# ===========================================================================
# EGNN  (Satorras et al., arXiv:2102.09844) — E(n)-equivariant, 4L, d=64
# ===========================================================================

@dataclass(frozen=True)
class EGNNConfig:
    name: str
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 0
    n_classes: int = 2
    dtype: str = "float32"


def egnn_init(cfg: EGNNConfig, generator: torch.Generator) -> dict:
    dt, d = _dtype(cfg), cfg.d_hidden
    layers = [{"phi_e": _mlp2_init(generator, 2 * d + 1, d, d, dt),
               "phi_x": _mlp2_init(generator, d, d, 1, dt),
               "phi_h": _mlp2_init(generator, 2 * d, d, d, dt)}
              for _ in range(cfg.n_layers)]
    return {"encoder": L.dense_init(generator, cfg.d_in, d, bias=True,
                                    dtype=dt),
            "layers": layers,
            "head": L.dense_init(generator, d, cfg.n_classes, bias=True,
                                 dtype=dt)}


def egnn_layer_terms(lp, h, x, src, dst, emask):
    """Per-edge terms of one EGNN layer: the masked scalar messages ``m``
    and the radially-weighted coordinate messages ``diff * phi_x(m)``.
    ``src`` and ``dst`` index rows of ``h`` and ``x`` (``GraphPrep``'s
    ``src_rows`` and ``dst_rows``)."""
    diff = x[dst] - x[src]                           # (E, 3)
    dist2 = torch.sum(torch.square(diff), dim=-1, keepdim=True)
    m = _mlp2(lp["phi_e"], torch.cat([h[dst], h[src], dist2], dim=-1)) \
        * emask
    xw = torch.tanh(_mlp2(lp["phi_x"], m))          # bounded for stability
    return m, diff * xw * emask


def egnn_apply(cfg: EGNNConfig, params, batch, *, n_graphs: int = 1,
               prep: GraphPrep | None = None):
    gp = prep or graph_prep(batch, n_graphs)
    params, batch = _on_rows(params, batch)
    pn, pe = gp.rows.views(params)
    emask = batch["edge_mask"][:, None]
    h = L.dense(pn["encoder"], batch["nodes"])
    x = batch["coords"].to(h.dtype)
    deg = _edge_sum(batch["edge_mask"], gp)[:, None] + 1.0
    for lp, lpe in zip(pn["layers"], pe["layers"]):
        m, xmsg = egnn_layer_terms(lpe, gp.rows.for_edges(h),
                                   gp.rows.for_edges(x), gp.src_rows,
                                   gp.dst_rows, emask)
        # coordinate update (equivariant)
        x = x + _edge_sum(xmsg, gp) / deg
        # feature update
        agg = _edge_sum(m, gp)
        h = h + _mlp2(lp["phi_h"], torch.cat([h, agg], dim=-1))
    graph_repr = _readout(h, batch["node_mask"], gp)
    return {"node_logits": L.dense(pn["head"], h),
            "graph_logits": L.dense(params["head"], graph_repr),
            "node_repr": h, "coords": x}


# ===========================================================================
# NequIP-lite  (Batzner et al., arXiv:2101.03164) — E(3)-equivariant
# interatomic potential; l<=2 feature algebra in the Cartesian basis.
# ===========================================================================

@dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    mul: int = 32            # channels per irrep order
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 4
    dtype: str = "float32"


#: coupling paths of ``_tp_messages``: one radial weight per (path, channel)
N_PATHS = 10


def _bessel_rbf(r, n_rbf, cutoff):
    """Bessel radial basis with smooth polynomial cutoff envelope."""
    r = torch.clamp_min(r, 1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    c = torch.sqrt(torch.tensor(2.0 / cutoff, dtype=torch.float32))
    basis = c * torch.sin(n * math.pi * r[..., None] / cutoff) \
        / r[..., None]
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1.0 - 10.0 * x**3 + 15.0 * x**4 - 6.0 * x**5   # p=3 poly cutoff
    return basis * env[..., None]


def nequip_init(cfg: NequIPConfig, generator: torch.Generator) -> dict:
    dt, C, dev = _dtype(cfg), cfg.mul, generator.device
    layers = [{
        "radial": _mlp2_init(generator, cfg.n_rbf, 32, N_PATHS * C, dt),
        "mix0": L.dense_init(generator, 2 * C, C, bias=True, dtype=dt),
        "mix1": L.dense_init(generator, 2 * C, C, dtype=dt),
        "mix2": L.dense_init(generator, 2 * C, C, dtype=dt),
        "gate1": L.dense_init(generator, C, C, bias=True, dtype=dt),
        "gate2": L.dense_init(generator, C, C, bias=True, dtype=dt),
    } for _ in range(cfg.n_layers)]
    table = torch.randn((cfg.n_species, C), generator=generator, dtype=dt,
                        device=dev) * 0.5
    return {"embed": {"table": table}, "layers": layers,
            "energy_head": _mlp2_init(generator, C, C, 1, dt)}


def _cross(a, b):
    """``jnp.cross`` over the last axis, in its order of operations."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _tp_messages(h0, h1, h2, Y1, Y2, src, w):
    """All l<=2 Cartesian coupling paths for one edge set.

    h0 (N,C) scalars; h1 (N,C,3) vectors; h2 (N,C,3,3) traceless symmetric.
    Y1 (E,3), Y2 (E,3,3) edge spherical tensors; w (E,10,C) radial weights.
    Returns per-edge messages (m0 (E,C), m1 (E,C,3), m2 (E,C,3,3)).
    """
    s0, s1, s2 = h0[src], h1[src], h2[src]
    wi = lambda i: w[:, i]                                   # (E, C)
    # --- scalar outputs ---
    m0 = (wi(0) * s0                                          # 0x0->0
          + wi(1) * torch.einsum("eci,ei->ec", s1, Y1)        # 1x1->0
          + wi(2) * torch.einsum("ecij,eij->ec", s2, Y2))     # 2x2->0
    # --- vector outputs ---
    m1 = (wi(3)[..., None] * s0[..., None] * Y1[:, None, :]   # 0x1->1
          + wi(4)[..., None] * s1                             # 1x0->1
          + wi(5)[..., None] * _cross(
              s1, Y1[:, None, :].expand(s1.shape))            # 1x1->1
          + wi(6)[..., None] * torch.einsum("ecij,ej->eci", s2, Y1))
    # --- rank-2 outputs ---
    outer = 0.5 * (torch.einsum("eci,ej->ecij", s1, Y1)
                   + torch.einsum("eci,ej->ecji", s1, Y1))
    tr = torch.einsum("ecii->ec", outer)
    eye = torch.eye(3, dtype=h0.dtype, device=h0.device)
    outer_tl = outer - tr[..., None, None] / 3.0 * eye        # 1x1->2
    m2 = (wi(7)[..., None, None] * s0[..., None, None] * Y2[:, None]
          + wi(8)[..., None, None] * s2                       # 2x0->2
          + wi(9)[..., None, None] * outer_tl)
    return m0, m1, m2


def _mix_vec(p, h1, a1):
    cat = torch.cat([h1, a1], dim=1)                 # (N, 2C, 3)
    return torch.einsum("nci,cd->ndi", cat, p["w"])


def _mix_mat(p, h2, a2):
    cat = torch.cat([h2, a2], dim=1)                 # (N, 2C, 3, 3)
    return torch.einsum("ncij,cd->ndij", cat, p["w"])


def nequip_apply(cfg: NequIPConfig, params, batch, *, n_graphs: int = 1,
                 prep: GraphPrep | None = None):
    """batch['nodes']: (N,) int32 species ids (or one-hot (N, n_species));
    coords (N, 3).  Returns per-atom and per-graph energy."""
    gp = prep or graph_prep(batch, n_graphs)
    params, batch = _on_rows(params, batch)
    pn, pe = gp.rows.views(params)
    N = batch["coords"].shape[0]
    src, dst, whole = gp.src_rows, gp.dst_rows, gp.rows.for_edges
    emask = batch["edge_mask"]
    C = cfg.mul
    species = batch["nodes"]
    table = pn["embed"]["table"]
    if species.dim() == 2:                      # one-hot -> embed matmul
        h0 = species @ table
    else:
        h0 = table[wrap_clamp_index(species, table.shape[0])]
    dt = h0.dtype
    h1 = torch.zeros((N, C, 3), dtype=dt, device=h0.device)
    h2 = torch.zeros((N, C, 3, 3), dtype=dt, device=h0.device)

    x = whole(batch["coords"].float())
    diff = x[dst] - x[src]
    r = torch.sqrt(torch.sum(torch.square(diff), dim=-1) + 1e-12)
    rhat = diff / r[:, None]
    Y1 = rhat.to(dt)
    eye = torch.eye(3, dtype=dt, device=h0.device)
    Y2 = (torch.einsum("ei,ej->eij", rhat, rhat) - eye / 3.0).to(dt)
    rbf = _bessel_rbf(r, cfg.n_rbf, cfg.cutoff).to(dt)

    for lp, lpe in zip(pn["layers"], pe["layers"]):
        w = _mlp2(lpe["radial"], rbf).reshape(-1, N_PATHS, C)
        w = w * emask[:, None, None]
        m0, m1, m2 = _tp_messages(whole(h0), whole(h1), whole(h2), Y1, Y2,
                                  src, w)
        a0 = _edge_sum(m0, gp)
        a1 = _edge_sum(m1, gp)
        a2 = _edge_sum(m2, gp)
        # self-interaction: mix (old, aggregated) channels per order
        h0 = L.dense(lp["mix0"], torch.cat([h0, a0], dim=-1))
        h1 = _mix_vec(lp["mix1"], h1, a1)
        h2 = _mix_mat(lp["mix2"], h2, a2)
        # gated nonlinearity: scalars gate the higher orders
        h0 = L.activation("silu", h0)
        g1 = torch.sigmoid(L.dense(lp["gate1"], h0))
        g2 = torch.sigmoid(L.dense(lp["gate2"], h0))
        h1 = h1 * g1[..., None]
        h2 = h2 * g2[..., None, None]

    atom_energy = _mlp2(pn["energy_head"], h0)[:, 0]
    atom_energy = atom_energy * batch["node_mask"]
    energy = gp.rows.node_total(segment_sum(atom_energy, gp.graphs,
                                            gp.n_graphs))
    return {"atom_energy": atom_energy, "energy": energy,
            "h0": h0, "h1": h1}


# ===========================================================================
# registry, loss helpers, weights
# ===========================================================================

GNN_MODELS = {
    "gin": (GINConfig, gin_init, gin_apply),
    "gatedgcn": (GatedGCNConfig, gatedgcn_init, gatedgcn_apply),
    "egnn": (EGNNConfig, egnn_init, egnn_apply),
    "nequip": (NequIPConfig, nequip_init, nequip_apply),
}


def label_log_prob(logp, labels):
    """``logp[i, labels[i]]`` as ``jnp.take_along_axis`` gives it: a label
    in [-C, 0) wraps once, one outside [-C, C) gives NaN (its default
    fill).  The gather reads at a clamped index, so nothing raises on the
    CPU and no device-side assert fires on the card."""
    C = logp.shape[-1]
    labels = labels.long()
    idx = torch.where(labels < 0, labels + C, labels)
    picked = torch.gather(logp, -1, idx.clamp(0, C - 1)[:, None])[:, 0]
    return torch.where((idx >= 0) & (idx < C), picked, float("nan"))


def gnn_node_loss(apply_fn, params, batch, n_classes):
    out = apply_fn(params, batch)
    logits = out["node_logits"].float()
    mask = batch["node_mask"]
    logp = torch.log_softmax(logits, dim=-1)
    ll = label_log_prob(logp, batch["labels"])
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def nequip_energy_loss(apply_fn, params, batch, n_graphs):
    out = apply_fn(params, batch, n_graphs=n_graphs)
    return torch.mean(torch.square(out["energy"] - batch["energy_target"]))


#: each model's parameter tree: (top-level keys, keys of a layer)
PARAM_TREES = {
    "gin": ({"encoder", "layers", "head"}, {"mlp", "eps"}),
    "gatedgcn": ({"encoder", "edge_encoder", "layers", "head"},
                 {"U", "V", "A", "B", "C"}),
    "egnn": ({"encoder", "layers", "head"}, {"phi_e", "phi_x", "phi_h"}),
    "nequip": ({"embed", "layers", "energy_head"},
               {"radial", "mix0", "mix1", "mix2", "gate1", "gate2"}),
}


def _tree_map(fn, node):
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree_map(fn, v) for v in node]
    return fn(node)


def params_from_reference(tree, device="cpu") -> dict:
    """The reference's ``*_init`` parameters of one of ``GNN_MODELS``, as a
    tree of numpy arrays (``jax.tree.map(np.asarray, params)``), as the
    port's tensors on ``device``.  Raises on a tree of another shape."""
    layers = tree.get("layers") if isinstance(tree, dict) else None
    if not isinstance(layers, (list, tuple)) or not any(
            set(tree) == top and all(set(lp) == keys for lp in layers)
            for top, keys in PARAM_TREES.values()):
        raise ValueError("not a GNN parameter tree: keys "
                         f"{sorted(tree) if isinstance(tree, dict) else tree}")
    return _tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                     tree)


def params_to(params: dict, device) -> dict:
    """A copy of ``params`` on ``device``."""
    return _tree_map(lambda t: t.to(device), params)
