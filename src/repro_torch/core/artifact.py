"""Durable, reloadable partition artifacts, in the reference package's
format: an artifact either package writes loads in the other's
``PartitionArtifact.load``, with byte-equal sidecars for the same run.
The manifest's ``spec`` is the reference-valid spec dict; the kernel route
the port took is recorded only in ``extras["kernel_backend"]``.

A ``PartitionArtifact`` persists everything downstream jobs need from a
partitioning run — so the paper's partition -> plan -> distributed
processing pipeline never re-streams the graph after the partitioner has
run once.  Directory layout::

    <dir>/
      assignment.bin    (E,) int32 edge -> partition memmap
      manifest.json     spec (to_dict), graph meta, quality, timings,
                        halo-plan capacity envelope, per-part edge counts,
                        and — when the run was traced — the pipeline stall
                        report (stage busy/idle fractions)
      halo_plan.npz     the full padded HaloPlan arrays (optional)
      host_plan.npz     host-grouped exchange tables (optional, format v2):
                        the ``HostHaloPlan`` re-slicing of halo_plan.npz
                        for a multi-host (DCN-aware) mesh layout

``PartitionArtifact.load(dir)`` memmaps the assignment lazily and
rebuilds cached ``HaloPlan``s straight from the ``.npz``:
``artifact.halo_plan()`` is bit-identical to a fresh
``plan_halo_exchange`` without touching the edge stream.
``artifact.host_halo_plan()`` does the same for the host-grouped layout.

Format history: v1 had no host plan; v2 adds the optional
``host_plan`` manifest block + ``.npz``; v3 adds the optional
``local_graphs`` block pointing at per-partition ``local_csc_p{i}.npz``
serving structure (``repro_torch.sample.local_graph``); v4 adds the
``integrity`` block — sha256 content checksums for every sidecar file,
verified by default on ``load`` — and makes ``save`` atomic end-to-end
(every file staged ``*.tmp`` + ``os.replace``, manifest written last, so
a crash mid-save leaves either the previous complete artifact or an
unloadable directory, never a loadable-but-wrong mix).  v1–v3 artifacts
still load unchanged (no checksums to verify).
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np

from ..robust.integrity import (atomic_path, checksum_files,
                                save_json_atomic, savez_atomic,
                                verify_checksums)
from .engine import PartitionRunResult
from .specs import PartitionerSpec, spec_from_dict

ASSIGNMENT_FILE = "assignment.bin"
MANIFEST_FILE = "manifest.json"
HALO_PLAN_FILE = "halo_plan.npz"
HOST_PLAN_FILE = "host_plan.npz"
FORMAT_VERSION = 4
SUPPORTED_VERSIONS = (1, 2, 3, 4)

#: HaloPlan fields that are plain ints/floats (stored as 0-d npz entries).
_PLAN_SCALARS = ("k", "v_cap", "e_cap", "b_cap", "o_cap",
                 "replication_factor")
#: HostHaloPlan scalar fields (its ``base`` lives in halo_plan.npz).
_HOST_SCALARS = ("num_hosts", "parts_per_host", "hb_cap")
_HOST_ARRAYS = ("host_of", "intra_send", "intra_recv", "hsend_idx",
                "hrecv_idx", "host_pair_sizes")


def _json_safe(d: dict) -> dict:
    return {k: v for k, v in d.items()
            if isinstance(v, (int, float, str, bool))}


@dataclass
class PartitionArtifact:
    """Handle to a persisted partition (see module docstring)."""

    path: str
    manifest: dict
    _assignment: np.ndarray | None = None
    _plan: object | None = None            # cached HaloPlan
    _host_plan: object | None = None       # cached HostHaloPlan
    _local_graphs: dict | None = None      # cached {part_id: LocalGraph}

    # -- accessors -------------------------------------------------------
    @property
    def k(self) -> int:
        return int(self.manifest["k"])

    @property
    def num_vertices(self) -> int:
        return int(self.manifest["num_vertices"])

    @property
    def num_edges(self) -> int:
        return int(self.manifest["num_edges"])

    @property
    def spec(self) -> PartitionerSpec:
        return spec_from_dict(self.manifest["spec"])

    @property
    def assignment(self) -> np.ndarray:
        """(E,) int32 edge -> partition ids, memmapped read-only."""
        if self._assignment is None:
            self._assignment = np.memmap(
                os.path.join(self.path, ASSIGNMENT_FILE), dtype=np.int32,
                mode="r", shape=(self.num_edges,))
        return self._assignment

    def has_halo_plan(self) -> bool:
        return os.path.exists(os.path.join(self.path, HALO_PLAN_FILE))

    def halo_plan(self):
        """Reload the persisted ``HaloPlan`` (cached; no graph IO)."""
        if self._plan is None:
            from ..dist.partitioned_gnn import HaloPlan
            npz_path = os.path.join(self.path, HALO_PLAN_FILE)
            if not os.path.exists(npz_path):
                raise FileNotFoundError(
                    f"{self.path} was saved without a halo plan; re-save "
                    f"with plan= or edges= to enable plan caching")
            with np.load(npz_path) as z:
                kw = {name: z[name] for name in z.files
                      if name not in _PLAN_SCALARS}
                kw.update({name: type_(z[name][()])
                           for name, type_ in zip(
                               _PLAN_SCALARS,
                               (int, int, int, int, int, float))})
            self._plan = HaloPlan(**kw)
        return self._plan

    def has_host_plan(self) -> bool:
        return os.path.exists(os.path.join(self.path, HOST_PLAN_FILE))

    def host_halo_plan(self):
        """Reload the persisted host-grouped ``HostHaloPlan`` (cached; no
        graph IO — its base plan comes from ``halo_plan()``)."""
        if self._host_plan is None:
            from ..dist.multihost import HostHaloPlan
            npz_path = os.path.join(self.path, HOST_PLAN_FILE)
            if not os.path.exists(npz_path):
                raise FileNotFoundError(
                    f"{self.path} was saved without a host plan; re-save "
                    f"with host_groups= (or --hosts) to enable the "
                    f"multi-host layout")
            with np.load(npz_path) as z:
                kw = {name: z[name] for name in _HOST_ARRAYS}
                kw.update({name: int(z[name][()])
                           for name in _HOST_SCALARS})
            self._host_plan = HostHaloPlan(base=self.halo_plan(), **kw)
        return self._host_plan

    def has_local_graphs(self) -> bool:
        """True when per-partition serving structure is registered
        (format v3 ``local_graphs`` manifest block)."""
        return self.manifest.get("local_graphs") is not None

    def local_graph(self, part_id: int):
        """Load partition ``part_id``'s ``LocalGraph`` (cached).

        Requires ``repro_torch.sample.build_local_graphs`` (or the CLI's
        ``--local-graphs``) to have run against this artifact."""
        if not self.has_local_graphs():
            raise FileNotFoundError(
                f"{self.path} has no local serving structure; run "
                f"repro_torch.sample.build_local_graphs(artifact) or "
                f"partition "
                f"with --local-graphs")
        if self._local_graphs is None:
            self._local_graphs = {}
        if part_id not in self._local_graphs:
            from ..sample.local_graph import LocalGraph
            fname = self.manifest["local_graphs"]["files"][part_id]
            self._local_graphs[part_id] = LocalGraph.load(
                os.path.join(self.path, fname))
        return self._local_graphs[part_id]

    def register_local_graphs(self, meta: dict) -> None:
        """Record the ``local_graphs`` block and rewrite the manifest.

        Called by ``repro_torch.sample.build_local_graphs`` after the per-
        partition ``.npz`` files land next to the manifest; bumps the
        on-disk format to at least v3 (older artifacts upgrade in place —
        newer readers treat an absent block exactly like a v2 artifact).
        Artifacts that carry an ``integrity`` block get checksums for the
        new per-partition files, and the manifest rewrite is atomic."""
        self.manifest["local_graphs"] = meta
        self.manifest["format_version"] = max(
            int(self.manifest.get("format_version") or 1), 3)
        integrity = self.manifest.get("integrity")
        if integrity is not None:
            integrity["files"].update(
                checksum_files(self.path, meta.get("files", [])))
        self._local_graphs = None
        save_json_atomic(os.path.join(self.path, MANIFEST_FILE),
                         self.manifest)

    # -- persistence -----------------------------------------------------
    @classmethod
    def save(cls, path: str, result: PartitionRunResult, *,
             num_vertices: int, num_edges: int,
             spec: PartitionerSpec | None = None,
             plan=None, edges: np.ndarray | None = None,
             stream=None, pair_cap_quantile: float = 1.0,
             host_groups=None,
             graph_path: str | None = None) -> "PartitionArtifact":
        """Persist a run.  The halo plan is taken from ``plan`` if given,
        else planned out-of-core from ``stream`` (an ``EdgeStream``,
        chunked against the just-written assignment memmap — O(chunk+plan)
        peak), else computed in-memory from ``edges``; with none of the
        three, the artifact carries only assignment + manifest.

        ``host_groups`` (a host count or explicit groups, see
        ``repro_torch.dist.multihost``) additionally persists the host-grouped
        re-slicing of the plan in ``host_plan.npz``; passing an already
        host-grouped ``HostHaloPlan`` as ``plan`` does the same."""
        spec = spec if spec is not None else result.spec
        if spec is None:
            raise ValueError("no spec: pass spec= or run via run_spec")
        os.makedirs(path, exist_ok=True)

        asg_path = os.path.join(path, ASSIGNMENT_FILE)
        asg = result.assignment
        if (isinstance(asg, np.memmap)
                and os.path.realpath(asg.filename) ==
                os.path.realpath(asg_path)):
            asg.flush()                    # engine already wrote in place
        else:
            with atomic_path(asg_path) as tmp:
                np.asarray(asg, dtype=np.int32).tofile(tmp)

        if plan is None and stream is not None:
            from ..dist.partitioned_gnn import plan_halo_exchange_stream
            asg_mm = np.memmap(asg_path, dtype=np.int32, mode="r",
                               shape=(num_edges,))
            plan = plan_halo_exchange_stream(
                stream, asg_mm, num_vertices, result.k,
                pair_cap_quantile=pair_cap_quantile)
        elif plan is None and edges is not None:
            from ..dist.partitioned_gnn import plan_halo_exchange
            plan = plan_halo_exchange(edges, np.asarray(asg), num_vertices,
                                      result.k,
                                      pair_cap_quantile=pair_cap_quantile)

        host_plan = None
        if plan is not None and hasattr(plan, "base"):   # HostHaloPlan
            host_plan, plan = plan, plan.base
        elif plan is not None and host_groups is not None:
            from ..dist.multihost import host_plan_from_halo
            host_plan = host_plan_from_halo(plan, host_groups)
        elif host_groups is not None:
            raise ValueError(
                "host_groups= needs a halo plan to re-slice: pass plan=, "
                "edges=, or stream= as well")

        manifest = {
            "format_version": FORMAT_VERSION,
            "spec": spec.to_dict(),
            "algorithm": result.name,
            "k": result.k,
            "num_vertices": int(num_vertices),
            "num_edges": int(num_edges),
            "graph_path": graph_path,
            "assignment_path": ASSIGNMENT_FILE,
            "replication_factor": result.quality.replication_factor,
            "alpha_measured": result.quality.balance,
            "timings_s": {kk: round(v, 6)
                          for kk, v in result.timings.items()},
            "simulated_io_s": round(result.simulated_io_seconds, 6),
            "extras": _json_safe(result.extras),
            # stall attribution from a traced run (repro_torch.obs): per-stage
            # busy/idle fractions + critical-stage verdict, None untraced
            "stall_report": result.extras.get("stall_report"),
            "halo_plan": None,
            "host_plan": None,
            "local_graphs": None,
        }
        if plan is not None:
            arrays = {f.name: getattr(plan, f.name)
                      for f in dataclasses.fields(plan)}
            savez_atomic(os.path.join(path, HALO_PLAN_FILE), **arrays)
            manifest["halo_plan"] = {
                "path": HALO_PLAN_FILE,
                "pair_cap_quantile": pair_cap_quantile,
                **{s: getattr(plan, s) for s in _PLAN_SCALARS},
            }
        if host_plan is not None:
            arrays = {name: getattr(host_plan, name)
                      for name in _HOST_ARRAYS + _HOST_SCALARS}
            savez_atomic(os.path.join(path, HOST_PLAN_FILE), **arrays)
            manifest["host_plan"] = {"path": HOST_PLAN_FILE,
                                     **host_plan.dcn_summary()}
        # content checksums over every sidecar; the manifest itself lands
        # last, so a crash anywhere above leaves no v4 manifest pointing
        # at missing/stale files — and a stale-manifest/new-files mix is
        # caught by verification at load time
        sidecars = [ASSIGNMENT_FILE]
        if manifest["halo_plan"] is not None:
            sidecars.append(HALO_PLAN_FILE)
        if manifest["host_plan"] is not None:
            sidecars.append(HOST_PLAN_FILE)
        manifest["integrity"] = {"algorithm": "sha256",
                                 "files": checksum_files(path, sidecars)}
        save_json_atomic(os.path.join(path, MANIFEST_FILE), manifest)
        return cls(path=path, manifest=manifest, _assignment=None,
                   _plan=plan, _host_plan=host_plan)

    @classmethod
    def load(cls, path: str, *, verify: bool = True) -> "PartitionArtifact":
        """Open a persisted artifact (lazy: the assignment memmaps on
        first access, plans rebuild from their ``.npz`` on first call).

        ``verify`` (default on) checks every file named in the manifest's
        ``integrity`` block against its recorded sha256 — a corrupted,
        truncated, or mixed-generation artifact raises
        ``repro_torch.robust.ArtifactIntegrityError`` here instead of producing
        silently wrong plans downstream.  Pre-v4 artifacts carry no
        checksums and skip verification.

        Example::

            art = PartitionArtifact.load("parts/")
            art.spec.algorithm        # exactly how it was produced
            art.assignment[:10]       # (E,) int32, no graph IO
            art.halo_plan()           # cached HaloPlan, no graph IO
        """
        with open(os.path.join(path, MANIFEST_FILE)) as f:
            manifest = json.load(f)
        version = manifest.get("format_version")
        if version not in SUPPORTED_VERSIONS:
            raise ValueError(f"{path}: unsupported artifact format "
                             f"{version!r} (want one of "
                             f"{SUPPORTED_VERSIONS})")
        integrity = manifest.get("integrity")
        if verify and integrity is not None:
            verify_checksums(path, integrity["files"],
                             label="partition artifact")
        return cls(path=path, manifest=manifest)
