"""Mesh-aware sharding-spec assignment, the counterpart of
``repro.dist.sharding``, and the specs as DTensor placements.

One place owns the mapping from parameter/batch trees to partition specs,
keyed only by mesh axis names and leaf shapes, so the same rules hold on a
test mesh, the 16x16 production mesh and the 2x16x16 multi-pod mesh:

- ``"model"`` is the tensor-parallel axis.
- every other axis is data parallelism; together they form the "fsdp" axis
  group (``fsdp_axes``), over which batch dims and the ZeRO-style parameter
  shards are split.  Multi-axis assignments always appear as tuples in the
  spec (``P(("pod", "data"), ...)``) so they stay valid when the pod axis
  exists.
- every assignment is divisibility-aware: an axis (group) is only used when
  it divides the dim, otherwise the dim stays replicated — a 60-expert MoE
  on a 16-wide model axis falls back to tensor parallelism over the expert
  FFN dim.

A spec is ``PartitionSpec``, a tuple with one entry per tensor dim: None
(replicated), an axis name, or a tuple of names (the dim split over those
axes, the first the outermost), entry for entry the reference's
``tuple(jax.sharding.PartitionSpec(...))``.  ``placements(mesh, spec)``
turns a spec into one DTensor placement per mesh dim.

``constrain`` is the in-model annotation primitive: the identity outside a
mesh context (``with device_mesh:``) or on a plain tensor, a
``DTensor.redistribute`` to the named placements otherwise.
"""
from __future__ import annotations

import numpy as np
import torch


def _entry(e):
    """An entry in the reference's canonical form: a one-name tuple is the
    name, an empty one None."""
    if isinstance(e, (tuple, list)):
        return None if not e else e[0] if len(e) == 1 else tuple(e)
    return e


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: a tuple of per-dim entries (None, an
    axis name, or a tuple of axis names), canonical as the reference's
    (``P("model", ("data",)) == P("model", "data")``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


# ---------------------------------------------------------------------------
# mesh introspection
# ---------------------------------------------------------------------------

def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names         # torch DeviceMesh
    return tuple(names)


def _axis_sizes(mesh) -> dict:
    """{axis name: size} for a torch ``DeviceMesh`` (``mesh_dim_names`` and
    ``shape``), the port's ``HostMesh``, or any mesh-shaped stand-in with
    ``axis_names`` + ``devices`` (tests use plain classes)."""
    names = _axis_names(mesh)
    devices = getattr(mesh, "devices", None)
    if devices is not None:
        return dict(zip(names, np.shape(devices)))
    return {n: int(s) for n, s in zip(names, tuple(mesh.shape))}


def fsdp_axes(mesh) -> tuple:
    """Every mesh axis that carries data parallelism (all but 'model')."""
    return tuple(n for n in _axis_names(mesh) if n != "model")


def _resolve_group(mesh, name) -> tuple:
    """An axis request -> tuple of real axis names ('fsdp' is the group of
    all data axes; a tuple passes through)."""
    if name == "fsdp":
        return fsdp_axes(mesh)
    if isinstance(name, (tuple, list)):
        return tuple(name)
    return (name,)


def _group_size(sizes: dict, group: tuple) -> int:
    return int(np.prod([sizes[a] for a in group])) if group else 1


def _current_mesh():
    """The ambient ``DeviceMesh`` (``with mesh:``), or None."""
    from torch.distributed.device_mesh import _mesh_resources
    stack = getattr(_mesh_resources, "mesh_stack", None)
    return stack[-1] if stack else None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


# ---------------------------------------------------------------------------
# spec assignment primitives
# ---------------------------------------------------------------------------

def best_spec(mesh, shape, prefs) -> PartitionSpec:
    """Greedy divisibility-aware spec: ``prefs`` is an ordered list of
    ``(dim, axis_name)`` requests.  A request is honored iff the axis (or
    'fsdp' group) divides ``shape[dim]``, the dim is still unassigned, and
    no axis is reused across dims; everything else stays replicated."""
    sizes = _axis_sizes(mesh)
    entries = [None] * len(shape)
    used = set()
    for dim, name in prefs:
        if entries[dim] is not None:
            continue
        group = tuple(a for a in _resolve_group(mesh, name)
                      if a in sizes and a not in used)
        if not group:
            continue
        if shape[dim] % _group_size(sizes, group):
            continue
        entries[dim] = group if name == "fsdp" or len(group) > 1 else group[0]
        used.update(group)
    return P(*entries)


def placements(mesh, spec) -> tuple:
    """One DTensor placement per dim of ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim ``d``'s entry names (a tuple entry names several,
    split in mesh order, the reference's major-to-minor nesting),
    ``Replicate()`` on the rest.  A mesh dim of one rank holds the whole
    tensor either way and is given ``Replicate()`` (DTensor refuses to
    flatten a dim sharded over one rank when the dim is 1 long)."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    sizes = _axis_sizes(mesh)
    out = [Replicate()] * len(names)
    used = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if a in used:
                raise ValueError(f"spec {spec}: mesh axis {a!r} used twice")
            used.add(a)
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def constrain(x, *axes):
    """``x`` redistributed to the placements ``axes`` name under the
    ambient mesh; the identity when no mesh is active or ``x`` is not a
    DTensor.  ``axes`` are ``(dim, axis_name)`` pairs; ``axis_name`` may be
    'fsdp'.  Non-divisible or absent axes are skipped so model code never
    has to special-case small/smoke shapes; a mesh dim no pair names is
    replicated, and with no pair honored ``x`` is left as it is (the
    reference's unconstrained case)."""
    mesh = _current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    sizes = _axis_sizes(mesh)
    entries = [None] * x.ndim
    used = set()
    for dim, name in axes:
        group = tuple(a for a in _resolve_group(mesh, name)
                      if a in sizes and a not in used)
        if not group:
            continue
        n = _group_size(sizes, group)
        if n == 1 or x.shape[dim] % n:
            continue
        entries[dim] = group if len(group) > 1 or name == "fsdp" else group[0]
        used.update(group)
    if all(e is None for e in entries):
        return x
    want = placements(mesh, P(*entries))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path=()):
    """``fn(keys, leaf)`` over a tree of dicts (keys in insertion order),
    lists and tuples; leaves are anything else (tensors, shape structs)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not is_spec(tree):
        return type(tree)(_map_with_path(fn, v, path) for v in tree)
    return fn(path, tree)


def _map(fn, tree):
    return _map_with_path(lambda _, leaf: fn(leaf), tree)


# ---------------------------------------------------------------------------
# LM parameter / batch rules
# ---------------------------------------------------------------------------

def lm_param_specs(mesh, params):
    """Spec tree mirroring an LM parameter tree (models/transformer.py).

    Layout: megatron-style TP over 'model' + ZeRO/FSDP over the data axes.
    Input projections (wq/wk/wv, mlp up/gate, lm_head) shard (in=fsdp,
    out=model); output projections (wo, mlp down) the transpose.  Embedding
    shards the vocab over 'model'.  MoE experts go expert-parallel over
    'model' when the expert count divides it, else TP falls back to the
    expert FFN dim.  Stacked layer leaves carry a leading replicated L dim;
    norms/biases replicate."""
    sizes = _axis_sizes(mesh)
    fsdp = tuple(a for a in fsdp_axes(mesh) if a in sizes)
    nf = _group_size(sizes, fsdp)
    nm = sizes.get("model", 1)

    def fsdp_if(dim):
        return fsdp if fsdp and dim % nf == 0 else None

    def model_if(dim):
        return "model" if "model" in sizes and dim % nm == 0 else None

    def rule(keys, leaf):
        keys = [k for k in keys if isinstance(k, str)]
        name = keys[-1] if keys else ""
        parent = keys[-2] if len(keys) > 1 else ""
        stacked = "layers" in keys
        shape = tuple(leaf.shape)
        eff = shape[1:] if stacked else shape
        if name in ("scale", "bias", "b") or len(eff) < 2:
            return P()
        lead = (None,) if stacked else ()
        if name == "table":                      # embedding (vocab, d)
            return P(*lead, model_if(eff[0]), fsdp_if(eff[1]))
        if parent == "experts":                  # (E, d, f) or (E, f, d)
            if model_if(eff[0]):                 # expert parallel
                if name == "down":
                    return P(*lead, "model", None, fsdp_if(eff[2]))
                return P(*lead, "model", fsdp_if(eff[1]), None)
            if name == "down":                   # TP fallback: ff dim
                return P(*lead, None, model_if(eff[1]), fsdp_if(eff[2]))
            return P(*lead, None, fsdp_if(eff[1]), model_if(eff[2]))
        if parent in ("wo", "down"):             # output projections
            return P(*lead, model_if(eff[0]), fsdp_if(eff[1]))
        return P(*lead, fsdp_if(eff[0]), model_if(eff[1]))

    return _map_with_path(rule, params)


def opt_state_specs(p_specs):
    """AdamW moments mirror the parameter layout; the step counter
    replicates.  (Structure matches ``optim.adamw_init``.)"""
    return {"m": p_specs, "v": p_specs, "step": P()}


def _leading_batch_specs(mesh, tree):
    """Shard the leading (batch-like) dim of every leaf over the fsdp axis
    group when it divides; replicate otherwise."""
    sizes = _axis_sizes(mesh)
    fsdp = tuple(a for a in fsdp_axes(mesh) if a in sizes)
    nf = _group_size(sizes, fsdp)

    def rule(leaf):
        shape = tuple(leaf.shape)
        if fsdp and shape and shape[0] % nf == 0:
            return P(fsdp)
        return P()

    return _map(rule, tree)


def lm_batch_specs(mesh, batch):
    """Token batches: (B, S) leaves split over the data axes."""
    return _leading_batch_specs(mesh, batch)


def lm_cache_specs(mesh, cache):
    """KV cache (L, B, Hkv, S, Dh): batch over fsdp, kv heads over 'model'
    when the head count divides it."""
    sizes = _axis_sizes(mesh)
    fsdp = tuple(a for a in fsdp_axes(mesh) if a in sizes)
    nf = _group_size(sizes, fsdp)
    nm = sizes.get("model", 1)

    def rule(leaf):
        shape = tuple(leaf.shape)
        if len(shape) < 3:
            return P()
        b = fsdp if fsdp and shape[1] % nf == 0 else None
        h = "model" if "model" in sizes and shape[2] % nm == 0 else None
        return P(None, b, h, *([None] * (len(shape) - 3)))

    return _map(rule, cache)


# ---------------------------------------------------------------------------
# GNN / recsys rules
# ---------------------------------------------------------------------------

def gnn_param_specs(mesh, params):
    """Full-graph baseline: every GNN parameter replicated."""
    return _map(lambda _: P(), params)


def gnn_batch_specs(mesh, batch):
    """Full-graph baseline: node/edge arrays split on their leading dim over
    the data axes where divisible."""
    return _leading_batch_specs(mesh, batch)


def recsys_param_specs(mesh, params):
    """DIEN: the item embedding table is the only large tensor — rows over
    'model', embed dim over fsdp; the GRU/MLP weights replicate."""
    sizes = _axis_sizes(mesh)
    fsdp = tuple(a for a in fsdp_axes(mesh) if a in sizes)
    nf = _group_size(sizes, fsdp)
    nm = sizes.get("model", 1)

    def rule(keys, leaf):
        shape = tuple(leaf.shape)
        if keys and keys[-1] == "table" and len(shape) == 2:
            r = "model" if "model" in sizes and shape[0] % nm == 0 else None
            c = fsdp if fsdp and shape[1] % nf == 0 else None
            return P(r, c)
        return P()

    return _map_with_path(rule, params)


def recsys_batch_specs(mesh, batch):
    return _leading_batch_specs(mesh, batch)


# ---------------------------------------------------------------------------
# placing trees on a DeviceMesh
# ---------------------------------------------------------------------------

def distribute(x, mesh, spec):
    """``x`` (the full tensor, the same on every rank) as a DTensor on
    ``mesh`` placed by ``spec``; each rank keeps its shard, copied."""
    from torch.distributed.tensor import distribute_tensor
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    x = x.to(mesh.device_type, copy=True)
    return distribute_tensor(x, mesh, placements(mesh, spec),
                             src_data_rank=None)


# ---------------------------------------------------------------------------
# DTensor helpers of the model code (identities on plain tensors)
# ---------------------------------------------------------------------------

def axis_size(mesh, name: str) -> int:
    return _axis_sizes(mesh).get(name, 1)


def coordinate(mesh, name: str) -> int:
    """This rank's index along mesh axis ``name``."""
    return int(mesh.get_coordinate()[_axis_names(mesh).index(name)])


def fsdp_entry(mesh, n: int):
    """The spec entry that splits a dim of ``n`` over the fsdp axis group,
    or None when the group is empty or does not divide ``n``."""
    sizes = _axis_sizes(mesh)
    group = tuple(a for a in fsdp_axes(mesh) if a in sizes)
    return group if group and n % _group_size(sizes, group) == 0 else None


def partial_where_sharded(pl, own=None) -> tuple:
    """The gradient placements of a local tensor laid out as ``own``
    (replicated by default) that a computation laid out as ``pl`` uses:
    the local tensor's own shard where ``own`` shards it, else a partial
    sum over each mesh dim that splits the computation, replicated over
    the rest."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    own = own or (Replicate(),) * len(pl)
    return tuple(o if isinstance(o, Shard) else
                 Partial() if isinstance(q, Shard) else Replicate()
                 for q, o in zip(pl, own))


def no_partial(pl) -> tuple:
    """``pl`` with every partial sum reduced (replicated)."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Replicate() if isinstance(q, Partial) else q for q in pl)


def whole_along(pl, dim: int) -> tuple:
    """``pl`` with tensor dim ``dim`` whole on every rank and no partial
    sum."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if q == Shard(dim) else q
                 for q in no_partial(pl))


def shard_index(mesh, dims) -> int:
    """The index of this rank's shard of a tensor dim split over mesh dims
    ``dims`` (in mesh order, the first the outermost)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + int(coord[i])
    return idx


def from_local(x, mesh, pl):
    """``DTensor.from_local`` of this rank's piece ``x`` (evenly split)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, mesh, pl, run_check=False)


def local_replica(t, grad_placements):
    """A DTensor ``t`` gathered whole onto every rank, as a plain tensor
    whose gradient is read back with ``grad_placements``
    (``partial_where_sharded`` of the computation that uses it); a plain
    tensor passes through."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    mesh = t.device_mesh
    whole = t.redistribute(mesh, (Replicate(),) * mesh.ndim)
    return whole.to_local(grad_placements=grad_placements)


def unbind(t):
    """``t.unbind(0)``; a DTensor (its dim 0 not sharded) is cut on each
    rank's local tensor, every slice a DTensor of the remaining dims."""
    if not is_dtensor(t):
        return t.unbind(0)
    from torch.distributed.tensor import Shard
    pl = []
    for q in t.placements:
        if isinstance(q, Shard):
            if q.dim == 0:
                raise ValueError("unbind: dim 0 is sharded")
            q = Shard(q.dim - 1)
        pl.append(q)
    mesh = t.device_mesh
    return tuple(from_local(x, mesh, tuple(pl))
                 for x in t.to_local().unbind(0))


def replicated_value(x):
    """A DTensor's whole value on every rank (a plain tensor); a plain
    tensor passes through."""
    return x.full_tensor() if is_dtensor(x) else x


def local_value(x):
    """This rank's local tensor of a DTensor (for a replicated one, its
    whole value), the very storage, outside autograd; a plain tensor
    passes through."""
    if not is_dtensor(x):
        return x
    with torch.no_grad():
        return x.to_local()


def redistribute(x, pl):
    """``x.redistribute`` to ``pl`` where they differ on a mesh dim of more
    than one rank; else ``x`` itself (no new autograd node)."""
    mesh = x.device_mesh
    if all(a == b or mesh.size(i) == 1
           for i, (a, b) in enumerate(zip(x.placements, pl))):
        return x
    return x.redistribute(mesh, pl)


# ---------------------------------------------------------------------------
# rows split over mesh dims: gathers and fixed-order sums (differentiable)
# ---------------------------------------------------------------------------
#
# A GNN or DIEN step on a mesh runs on plain local tensors, each either
# split by rows over some mesh dims (this rank holds its shard's rows) or
# whole (the same on every rank); a gradient follows its tensor's layout
# (a whole tensor's gradient is its whole gradient, the same on every
# rank).  The four functions below move between the two and sum partial
# results; every sum adds the ranks' terms in rank order (``rank_stack``
# then ``ordered_sum``), so every rank holds the same bits whatever the
# collective's algorithm.  ``dims`` are mesh dims; those of one rank are
# dropped, and with none left each function returns its input itself (no
# collective and no autograd node: a (1, 1) mesh computes what one device
# does).

def split_dims(x) -> tuple:
    """The mesh dims of more than one rank over which DTensor ``x``'s dim 0
    is split, in mesh order; () for a plain tensor."""
    if not is_dtensor(x):
        return ()
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    return tuple(i for i, q in enumerate(x.placements)
                 if q == Shard(0) and mesh.size(i) > 1)


def _live(mesh, dims) -> tuple:
    return tuple(i for i in dims if mesh.size(i) > 1)


def rank_stack(x, mesh, dims):
    """Every rank's ``x`` (of one shape on all) stacked in rank order over
    mesh dims ``dims`` (``shard_index``'s order): (R, *x.shape), no
    autograd."""
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Shard(0) if i in dims else Replicate()
               for i in range(mesh.ndim))
    with torch.no_grad():
        return from_local(x.detach().contiguous()[None], mesh,
                          pl).full_tensor()


def ordered_sum(stack):
    """``stack[0] + stack[1] + ...``, in that order."""
    out = stack[0].clone()
    for t in stack[1:]:
        out += t
    return out


def own_rows(x, mesh, dims, dim: int = 0):
    """This rank's shard of ``x``'s rows (along ``dim``), split over
    ``dims``."""
    n = x.shape[dim] // int(np.prod([mesh.size(i) for i in dims]))
    return x.narrow(dim, shard_index(mesh, dims) * n, n)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, partial_grad):
        ctx.mesh, ctx.dims, ctx.partial_grad = mesh, dims, partial_grad
        return rank_stack(x, mesh, dims).reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        mesh, dims = ctx.mesh, ctx.dims
        if ctx.partial_grad:       # every rank's part of the gradient
            g = ordered_sum(rank_stack(g, mesh, dims))
        return own_rows(g, mesh, dims), None, None, None


class _SumRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, rows):
        ctx.mesh, ctx.dims, ctx.rows = mesh, dims, rows
        stack = rank_stack(x, mesh, dims)
        if rows:
            stack = own_rows(stack, mesh, dims, dim=1)
        return ordered_sum(stack)

    @staticmethod
    def backward(ctx, g):
        if ctx.rows:
            g = rank_stack(g, ctx.mesh, ctx.dims).reshape(
                (-1,) + tuple(g.shape[1:]))
        return g, None, None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ordered_sum(rank_stack(g, ctx.mesh, ctx.dims)), None, None


def gather_rows(x, mesh, dims, *, partial_grad: bool = True):
    """The whole tensor of rows split over ``dims`` (this rank's shard
    ``x``), for a computation that reads all rows: an all-gather.  With
    ``partial_grad`` the reader is itself split over ``dims`` (its
    gradient a partial sum, summed over the ranks back into this rank's
    rows: a reduce-scatter), else whole (each rank keeps its rows of the
    gradient)."""
    dims = _live(mesh, dims)
    if not dims:
        return x
    return _GatherRows.apply(x, mesh, dims, partial_grad)


def sum_over(x, mesh, dims):
    """Each rank's partial ``x`` summed over ``dims``, whole on every rank,
    for a whole reader (a readout, a loss): an all-reduce.  A reader split
    over ``dims`` (a batch norm of each rank's rows) reads it through
    ``sum_grads``."""
    dims = _live(mesh, dims)
    if not dims:
        return x
    return _SumRanks.apply(x, mesh, dims, False)


def sum_into_rows(x, mesh, dims):
    """Each rank's partial ``x`` summed over ``dims``, this rank keeping
    its shard of the rows: a reduce-scatter (segment sums into node
    rows)."""
    dims = _live(mesh, dims)
    if not dims:
        return x
    return _SumRanks.apply(x, mesh, dims, True)


def sum_grads(x, mesh, dims):
    """``x`` (whole, the same on every rank) as read by a computation split
    over ``dims``: the identity, its gradient summed over ``dims`` (an
    all-reduce in the backward)."""
    dims = _live(mesh, dims)
    if not dims:
        return x
    return _SumGrads.apply(x, mesh, dims)


def whole_local(t):
    """A DTensor ``t`` gathered whole onto every rank as a plain tensor
    (``local_replica``) whose gradient is the whole gradient, the same on
    every rank, sent back to ``t``'s own placements; a plain tensor passes
    through."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return local_replica(t, (Replicate(),) * t.device_mesh.ndim)

