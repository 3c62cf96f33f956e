"""Per-device collective wire-bytes, the counterpart of
``repro.launch.hlo_analysis``.

``parse_collectives`` reads post-SPMD HLO text (framework-free regex code,
a copy of the reference's, held to it by the tests).
``collectives_from_trace`` builds the same dict from the collectives that
one rank issues while a step is traced (``launch.dryrun``): DTensor's
functional ones (``torch.ops._c10d_functional``) and ``torch.distributed``'s
in-place ones (``torch.ops.c10d``), each recorded by ``collective_record``
as the bytes of the tensor the ring estimate is taken of and the size of
the group it runs over.

Ring estimates, per device: all-reduce 2(n-1)/n of the tensor;
all-gather (n-1)/n of the gathered (full) tensor; reduce-scatter (n-1)/n
of the full input; all-to-all (n-1)/n; collective-permute 1x.  A group of
one rank moves nothing and is skipped (a collective-permute is counted
whatever its group).
"""
from __future__ import annotations

import re

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3": 1,
                "f8e5m2": 1, "s64": 8, "s32": 4, "s16": 2, "s8": 1,
                "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1,
                "c64": 8, "c128": 16}

# instruction lines look like:  %name = <shapes> <op>(operands), ...
# <shapes> may be one shape or a (possibly huge) tuple with /*index=N*/
# comments (e.g. a 256-way all-to-all or a whole-gradient-pytree
# all-reduce), so shapes are findall'd from the text between '=' and the op.
_COLL_RE = re.compile(
    r" = (.*?)\s?"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"(\w+?)\[([\d,]*)\]")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")


def _tensor_bytes(shapes_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shapes_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _wire(kind: str, size: int, n: int) -> float | None:
    """A collective's ring estimate of per-device wire bytes, or None when
    it moves nothing (a group of one)."""
    if kind == "collective-permute":
        return float(size)     # point-to-point: no group discount
    if n <= 1:
        return None
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / n
    return float(size) * (n - 1) / n


def _totals(records) -> dict:
    """The dict of both parsers from (kind, bytes, group size) records."""
    out = dict.fromkeys(KINDS, 0.0)
    out["count"] = 0
    for kind, size, n in records:
        wire = _wire(kind, size, n)
        if wire is None:
            continue
        out[kind] += wire
        out["count"] += 1
    out["total_bytes"] = sum(out[k] for k in KINDS)
    return out


def parse_collectives(hlo_text: str) -> dict:
    """Per-device bytes-on-wire per collective kind, ring estimates:
    all-reduce 2(n-1)/n, all-gather/reduce-scatter/all-to-all (n-1)/n of the
    (full) tensor, collective-permute 1x."""
    records = []
    for line in hlo_text.splitlines():
        if "-done" in line:
            continue
        m = _COLL_RE.search(line)
        if not m:
            continue
        shapes_str, kind = m.groups()
        gm = _GROUPS_IOTA_RE.search(line)
        if gm:
            n = int(gm.group(2))
        else:
            gl = _GROUPS_LIST_RE.search(line)
            n = len(gl.group(1).split(",")) if gl else 1
        records.append((kind, _tensor_bytes(shapes_str), n))
    return _totals(records)


# ---------------------------------------------------------------------------
# the functional collectives of a traced step
# ---------------------------------------------------------------------------

#: collective op name -> (kind, which tensor the estimate is of): the
#: functional collectives (``_c10d_functional``, DTensor's) by the name of
#: their argument, the in-place ones (``c10d``, ``torch.distributed``'s
#: calls) by their argument's position
_FUNCTIONAL = {
    "all_reduce": ("all-reduce", "input"),
    "all_reduce_coalesced": ("all-reduce", "input"),
    "all_gather_into_tensor": ("all-gather", "output"),
    "all_gather_into_tensor_coalesced": ("all-gather", "output"),
    "reduce_scatter_tensor": ("reduce-scatter", "input"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "input"),
    "all_to_all_single": ("all-to-all", "input"),
}
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
}


def _nbytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return int(x.numel()) * x.element_size()


def _group_size(group_name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()


def _process_group(func, args):
    """The process group among a ``c10d`` op's arguments (a TorchScript
    object there), by the op's schema."""
    from torch.distributed import ProcessGroup
    for a, arg in zip(args, func._schema.arguments):
        if "ProcessGroup" in str(arg.type):
            return a if isinstance(a, ProcessGroup) else ProcessGroup.unbox(a)
    raise ValueError(f"{func}: no process group among its arguments")


def collective_record(func, args, kwargs, out):
    """The (kind, bytes, group size) record of one call of a collective op
    (``func`` with its ``args``, ``kwargs`` and output), or None when
    ``func`` is not a collective (``wait_tensor`` among them: the issue of
    a collective is counted, not its wait, as HLO's ``-done`` is not)."""
    if func.namespace == "_c10d_functional":
        spec = _FUNCTIONAL.get(func._opname)
        if spec is None:
            return None
        kind, which = spec
        group_name = kwargs.get("group_name", args[-1])
        size = _nbytes(args[0] if which == "input" else out)
        return kind, size, _group_size(group_name)
    if func.namespace == "c10d":
        spec = _C10D.get(func._opname)
        if spec is None:
            return None
        kind, pos = spec
        return kind, _nbytes(args[pos]), _process_group(func, args).size()
    return None


def collectives_from_trace(records) -> dict:
    """``parse_collectives``' dict from the (kind, bytes, group size)
    records of a traced step's collectives (``collective_record``)."""
    return _totals(records)
