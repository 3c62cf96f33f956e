"""Dry run of the port, the counterpart of ``repro.launch.dryrun``: every
(architecture x shape x production mesh) cell traced at its published
config, with per-device FLOPs, bytes, memory and collective bytes, and not
one real buffer allocated.

The reference forces 512 placeholder host devices, lowers and compiles
each cell on the (16, 16) or (2, 16, 16) mesh and reads XLA's cost and
memory analyses.  The port starts a ``"fake"`` process group of 512 ranks
in this process, as rank 0 (``fake_world``; only ``main`` and ``run_cell``
do, never an import), builds the production mesh over its first 256 or
512 ranks (``launch.mesh.make_device_mesh(..., device="cpu")``; a DTensor
collective runs over a mesh dim's group, so the world's size beyond the
mesh changes nothing), places the cell's
abstract state and batch by the production rules as DTensors of fake
tensors (``FakeTensorMode``), and runs the port's own step on them once.
Fake tensors carry no data, so every op takes its plain CPU route, as the
reference lowers on placeholder host devices: no kernel is launched or
timed here, and the trace is not a route of the main path.

``TraceCosts`` watches the trace on rank 0's local tensors (a DTensor op is
left to DTensor, whose local ops it then sees):

- ``flops_per_device``: ``torch.utils.flop_counter``'s formulas on rank 0's
  local operations (matmuls, convolutions, attention products; elementwise
  work is not counted, where XLA's cost analysis counts it), never a
  global count divided by the ranks, since much work is replicated;
- ``bytes_per_device``: the bytes rank 0's local aten operations read and
  write (tensor operands plus outputs; views and empty allocations move
  none).  This is the unfused counterpart of XLA's "bytes accessed", so
  it runs higher;
- ``memory``: ``argument_bytes`` and ``output_bytes`` are rank 0's local
  shards (a decode step's int position counts as the int32 scalar the
  reference traces); ``alias_bytes`` the outputs that share storage with
  an argument the step updates in place (the train state, the decode
  cache: the reference's donation); ``temp_bytes`` the peak of live fake
  storage above the arguments during the step; ``peak_estimate_bytes``
  the reference's formula, arguments + outputs + temp - alias;
- ``collectives``: ``hlo_analysis.collectives_from_trace`` of the
  collectives rank 0 issues, by the ring estimates of
  ``hlo_analysis.parse_collectives``.  DTensor and GSPMD choose different
  collectives, so these are recorded beside the reference's, not held
  equal to them.

``lower_s`` is the seconds of placing the arguments and tracing the step;
``compile_s`` is 0.0, since nothing is compiled.  The trace is eager and sees every layer, so the reference's
two-point extrapolation over the layer count is not needed;
``_cell_costs(..., n_layers=)`` stays for checking it.

A GNN cell's batch preparation reads ids on the host; the dry run prepares
it shape-only (``models.gnn.graph_prep(..., abstract=True)``, with no hub
rows, no cut-off segment and uniform-degree row blocks) and hands it to
the step (``make_gnn_train_step(..., prep=)``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dien \\
        --shape serve_p99 --mesh both --out /tmp/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import time
import traceback
import weakref
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, get_arch
from ..dist import sharding as SH
from . import steps as S
from .hlo_analysis import collective_record, collectives_from_trace
from .mesh import make_device_mesh

#: hillclimb knobs: {"remat": ..., "microbatches": ..., "moe_groups": ...}
VARIANT = {}

#: the production meshes: (shape, axis names) by ``multi_pod``
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}

#: the shape kinds whose state the step updates in place (the reference
#: donates it)
DONATE_STATE = ("train", "full", "sampled", "molecule")

_NO_BYTES = ("empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided")


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

def fake_world(n: int) -> None:
    """A ``"fake"`` process group of ``n`` ranks with this process as rank
    0 (its collectives move nothing and return tensors of the right
    shape); an existing fake group of at least ``n`` ranks is kept.  A
    smaller fake group or a real one raises: a group is never torn down
    here, since DTensor's caches keep the meshes they have seen and a mesh
    over a destroyed group cannot be used again."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < n:
            raise RuntimeError(f"fake_world({n}): a {dist.get_backend()} "
                               f"process group of {dist.get_world_size()} "
                               f"ranks is already initialized")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def production_mesh(multi_pod: bool):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with
    ``"pod"`` in front, on the CPU over ranks 0 .. 255 or 0 .. 511 of one
    fake world of 512 ranks (the larger mesh's), so that one process can
    trace on both."""
    shape, axes = MESHES[multi_pod]
    fake_world(max(int(np.prod(s)) for s, _ in MESHES.values()))
    return make_device_mesh(shape, axes, device="cpu")


# ---------------------------------------------------------------------------
# counting a traced step on rank 0
# ---------------------------------------------------------------------------

def _storage(t):
    return t.untyped_storage()


def _tensors(tree) -> list:
    """The tensors of a tree of lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _op_info(func, registry) -> tuple:
    """(whether ``func`` moves bytes, its FLOP formula or None, whether it
    may be a collective): an aten op that is not a view (an in-place op
    is counted; it writes) and not an empty allocation moves bytes."""
    view = any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)
    moves = (func.namespace == "aten" and not view
             and func._opname not in _NO_BYTES)
    return (moves, registry.get(func._overloadpacket),
            func.namespace in ("_c10d_functional", "c10d"))


class TraceCosts(TorchDispatchMode):
    """Counts rank 0's local work while a step runs: FLOPs, bytes read and
    written, collectives, and the peak of live storage made during the
    step (``peak_bytes``; storages in ``known`` are not counted).  An op
    on DTensors is left to DTensor (``NotImplemented``), whose local ops
    then come back here.  The ops DTensor's sharding propagation runs on
    global shapes to learn an output's shape (in the active fake mode) are
    not counted: while the mode is on, the propagator's
    ``_propagate_tensor_meta_non_cached`` marks them."""

    def __init__(self, known=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary
        self.flop_registry = flop_registry
        self._ops = {}
        self.flops = 0
        self.bytes = 0
        self.collectives = []
        self.live = 0
        self.peak_bytes = 0
        self._seen = WeakIdKeyDictionary()
        for st in known:
            self._seen[st] = None
        self._refs = set()
        self._propagating = 0
        self._unpatch = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        meta = SP._propagate_tensor_meta_non_cached

        def marked(prop, op_schema):
            self._propagating += 1
            try:
                return meta(prop, op_schema)
            finally:
                self._propagating -= 1
        SP._propagate_tensor_meta_non_cached = marked
        self._unpatch = lambda: setattr(
            SP, "_propagate_tensor_meta_non_cached", meta)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()

    def _free(self, ref, nbytes):
        self._refs.discard(ref)
        self.live -= nbytes

    def _track(self, outs):
        for t in outs:
            st = _storage(t)
            if st in self._seen:
                continue
            nbytes = st.nbytes()
            self._seen[st] = nbytes
            self.live += nbytes
            self._refs.add(weakref.ref(
                st, lambda r, n=nbytes: self._free(r, n)))
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        info = self._ops.get(func)
        if info is None:
            info = self._ops[func] = _op_info(func, self.flop_registry)
        moves, formula, collective = info
        if collective:
            record = collective_record(func, args, kwargs, out)
            if record is not None:
                self.collectives.append(record)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if moves:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors(args) + _tensors(kwargs)
                              + outs)
        self._track(outs)
        return out


# ---------------------------------------------------------------------------
# per-cell building
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    """A cell ready to trace: ``fn(*args)`` under ``fake_mode`` and ``with
    mesh:``; ``donated`` the indices of the arguments the step updates in
    place; ``extra_argument_bytes`` the bytes of arguments that are not
    tensors here (a decode step's position, an int32 scalar in the
    reference)."""
    fn: object
    args: tuple
    fake_mode: object
    mesh: object
    donated: tuple = ()
    extra_argument_bytes: int = 0


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def _place(tree, mesh, specs):
    """Meta tree -> DTensors of fake tensors on ``mesh`` placed by
    ``specs`` (under the caller's ``FakeTensorMode``)."""
    def leaf(t, spec):
        fake = torch.empty(tuple(t.shape), dtype=t.dtype, device="cpu")
        return SH.distribute(fake, mesh, spec)
    return _map_specs(leaf, tree, specs)


def _train_specs(p_specs):
    return {"params": p_specs, "opt": SH.opt_state_specs(p_specs)}


def build_cell(arch_id: str, shape_name: str, mesh, *, n_layers=None,
               microbatches=None) -> Cell:
    """The cell's step and its arguments, placed on ``mesh`` by the
    production rules as DTensors of fake tensors.  ``n_layers`` overrides
    the depth and ``microbatches`` the accumulation depth (the cost traces
    of ``_cell_costs``); the module-level ``VARIANT`` dict overrides
    remat, microbatches and MoE dispatch groups."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..models import gnn as G
    spec = get_arch(arch_id)
    cfg = spec.config_for_shape(shape_name)
    if n_layers is not None and hasattr(cfg, "n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if VARIANT.get("remat") and hasattr(cfg, "remat"):
        cfg = dataclasses.replace(cfg, remat=VARIANT["remat"])
    if VARIANT.get("moe_groups") and getattr(cfg, "moe", None):
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(
                cfg.moe, dispatch_groups=VARIANT["moe_groups"]))
    sh = spec.shapes[shape_name]
    if VARIANT.get("microbatches"):
        sh = {**sh, "microbatches": VARIANT["microbatches"]}
    kind = sh["kind"]
    inputs = spec.input_specs(shape_name, cfg)
    family = spec.family
    params_abs = S.init_state_abstract(family, cfg, "serve")
    train_abs = (S.init_state_abstract(family, cfg, "train")
                 if kind in DONATE_STATE else None)
    mode = FakeTensorMode()
    extra = 0
    donated = ()
    with mode:
        if family == "lm":
            p_specs = SH.lm_param_specs(mesh, params_abs)
            if kind == "train":
                mb = microbatches or sh.get("microbatches", 1)
                fn = S.make_lm_train_step(cfg, microbatches=mb)
                args = (_place(train_abs, mesh, _train_specs(p_specs)),
                        _place(inputs, mesh,
                               SH.lm_batch_specs(mesh, inputs)))
                donated = (0,)
            elif kind == "prefill":
                fn = S.make_lm_prefill_step(cfg)
                args = (_place(params_abs, mesh, p_specs),
                        _place(inputs, mesh,
                               SH.lm_batch_specs(mesh, inputs)))
            else:  # decode
                fn = S.make_lm_decode_step(cfg)
                cache, tokens = inputs["cache"], inputs["tokens"]
                batch = {
                    "cache": _place(cache, mesh,
                                    SH.lm_cache_specs(mesh, cache)),
                    "tokens": _place(tokens, mesh,
                                     SH.lm_batch_specs(mesh, tokens)),
                    # the last position: the step attends the whole cache
                    "pos": int(sh["seq"]) - 1,
                }
                extra = inputs["pos"].element_size()
                args = (_place(params_abs, mesh, p_specs), batch)
                donated = (1,)
        elif family == "gnn":
            n_graphs = sh.get("batch", 1) if kind == "molecule" else 1
            p_specs = SH.gnn_param_specs(mesh, train_abs["params"])
            batch_abs = inputs["batch"]
            batch = _place(batch_abs, mesh,
                           SH.gnn_batch_specs(mesh, batch_abs))
            prep = G.graph_prep(batch, n_graphs,
                                reverse=S._gnn_kind(cfg) == "gin",
                                abstract=True)
            fn = S.make_gnn_train_step(cfg, kind, n_graphs=n_graphs,
                                       prep=prep)
            args = (_place(train_abs, mesh, _train_specs(p_specs)), batch)
            donated = (0,)
        else:  # recsys
            p_specs = SH.recsys_param_specs(mesh, params_abs)
            batch = _place(inputs, mesh,
                           SH.recsys_batch_specs(mesh, inputs))
            if kind == "train":
                fn = S.make_recsys_train_step(cfg)
                args = (_place(train_abs, mesh, _train_specs(p_specs)),
                        batch)
                donated = (0,)
            elif kind == "serve":
                fn = S.make_recsys_serve_step(cfg)
                args = (_place(params_abs, mesh, p_specs), batch)
            else:  # retrieval
                fn = S.make_recsys_retrieval_step(cfg)
                args = (_place(params_abs, mesh, p_specs), batch)
    return Cell(fn=fn, args=args, fake_mode=mode, mesh=mesh,
                donated=donated, extra_argument_bytes=extra)


def _local_tensors(tree) -> list:
    return [SH.local_value(t) for t in _tensors(tree)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def trace(cell: Cell) -> dict:
    """Runs the cell's step once on its fake arguments under
    ``TraceCosts``; returns the counts, the memory record and the trace's
    seconds."""
    args = _local_tensors(cell.args)
    arg_storages = [_storage(t) for t in args]
    t0 = time.perf_counter()
    with cell.fake_mode, cell.mesh, TraceCosts(arg_storages) as tc:
        out = cell.fn(*cell.args)
    seconds = time.perf_counter() - t0
    outs = _local_tensors(out)
    donated = {_storage(t)._cdata for i in cell.donated
               for t in _local_tensors(cell.args[i])}
    alias = [t for t in outs if _storage(t)._cdata in donated]
    arg_b = _nbytes(args) + cell.extra_argument_bytes
    out_b = _nbytes(outs)
    alias_b = _nbytes(alias)
    temp_b = tc.peak_bytes
    return {
        "seconds": seconds, "flops": float(tc.flops),
        "bytes": float(tc.bytes),
        "collectives": collectives_from_trace(tc.collectives),
        "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                   "temp_bytes": temp_b, "alias_bytes": alias_b,
                   "peak_estimate_bytes": arg_b + out_b + temp_b - alias_b},
    }


def _cell_costs(arch_id, shape_name, mesh, *, n_layers=None):
    """(flops, bytes, collectives) of one trace at ``n_layers`` with one
    microbatch, as the reference's cost compiles (which need two depths
    to see through the layer scan; the port's trace sees every layer)."""
    t = trace(build_cell(arch_id, shape_name, mesh, n_layers=n_layers,
                         microbatches=1))
    return t["flops"], t["bytes"], t["collectives"]


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True) -> dict:
    """The cell's record (the reference's keys) on the production mesh."""
    mesh = production_mesh(multi_pod)
    t0 = time.perf_counter()
    cell = build_cell(arch_id, shape_name, mesh)
    t = trace(cell)
    t_lower = time.perf_counter() - t0
    shape = tuple(mesh.shape)
    mem = t["memory"]
    rec = {
        "arch": arch_id, "shape": shape_name,
        "mesh": "x".join(str(s) for s in shape),
        "multi_pod": multi_pod, "n_devices": int(np.prod(shape)),
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        "flops_per_device": t["flops"],
        "bytes_per_device": t["bytes"],
        "memory": mem,
        "collectives": t["collectives"],
    }
    if verbose:
        colls = rec["collectives"]
        print(f"[{arch_id} x {shape_name} x {rec['mesh']}] "
              f"trace={t_lower:.1f}s "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"coll={colls['total_bytes']:.3e}B "
              f"mem(temp)={mem['temp_bytes'] / 2**30:.2f}GiB")
        print("  memory:", mem)
        print("  costs: flops=%.4g bytes=%.4g" % (
            rec["flops_per_device"], rec["bytes_per_device"]))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--remat", default=None,
                    choices=["none", "full", "dots"],
                    help="hillclimb: override the remat policy")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="hillclimb: override gradient-accumulation depth")
    ap.add_argument("--moe-groups", type=int, default=None,
                    help="hillclimb: MoE dispatch groups (EP-local sort)")
    args = ap.parse_args(argv)
    if args.remat:
        VARIANT["remat"] = args.remat
    if args.microbatches:
        VARIANT["microbatches"] = args.microbatches
    if args.moe_groups:
        VARIANT["moe_groups"] = args.moe_groups

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    results, failures = [], []
    for arch_id in archs:
        for shape_name in _shapes(arch_id, args.shape, archs):
            for mp in meshes:
                tag = f"{arch_id}__{shape_name}__{'2x16x16' if mp else '16x16'}"
                path = os.path.join(args.out, tag + ".json")
                try:
                    rec = run_cell(arch_id, shape_name, multi_pod=mp)
                    results.append(rec)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append((tag, str(e)))
                    with open(path + ".failed", "w") as f:
                        f.write(traceback.format_exc())

    print(f"\n=== dry-run complete: {len(results)} ok, "
          f"{len(failures)} failed ===")
    # nothing of a cell's size is allocated: the process stays small
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"peak RSS {rss:.2f} GiB")
    for tag, err in failures:
        print("FAILED:", tag, "--", err.splitlines()[-1] if err else "")
    return 1 if failures else 0


def _shapes(arch_id: str, shape_arg: str, archs) -> list:
    """The shapes of ``arch_id`` to run: all of them, or those named that
    it has; a named shape that none of ``archs`` has is kept, so that its
    cell fails (a ``.failed`` file) rather than vanish."""
    spec = get_arch(arch_id)
    if shape_arg == "all":
        return list(spec.shapes)
    return [s for s in shape_arg.split(",") if s in spec.shapes
            or not any(s in get_arch(a).shapes for a in archs)]


if __name__ == "__main__":
    raise SystemExit(main())
