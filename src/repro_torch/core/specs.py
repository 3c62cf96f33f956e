"""Declarative partitioner specifications.

A ``PartitionerSpec`` is a frozen, validated, JSON-serializable description
of *how* to partition — algorithm plus hyper-parameters, never graph data.
Specs are the single configuration currency of the partitioning stack:

* the streaming engine (``engine.run_spec``) executes them — every
  partitioner is a plug-in state machine over the same out-of-core driver;
* ``PartitionArtifact`` manifests embed them (``to_dict``/``from_dict``), so
  a persisted partition records exactly how it was produced and can be
  reproduced from the manifest alone;
* the name registry (``spec_for`` / ``SPEC_REGISTRY``) replaces the old
  ``PARTITIONERS`` name->function dict and the benchmarks' ad-hoc kwarg
  tables: one canonical name per algorithm variant, presets included.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import ClassVar


class SpecError(ValueError):
    """A PartitionerSpec failed validation."""


def _check(cond: bool, msg: str):
    if not cond:
        raise SpecError(msg)


@dataclass(frozen=True)
class PartitionerSpec:
    """Base spec: balance slack + streaming chunk size + engine pipelining,
    shared by all algorithms.  Subclasses add algorithm hyper-parameters and
    must define the ``algorithm`` registry key via the ``algorithm``
    property.

    ``pipeline_depth`` is the engine's in-flight chunk budget: chunk k+1's
    read + device dispatch overlap chunk k's host materialization and
    memmap writeback.  Depth 1 is the fully synchronous engine; any depth
    produces bit-identical assignments (the chunk kernels always execute in
    stream order — only writeback is deferred).

    ``scoring_backend`` keeps the reference's two values (``"jnp"`` |
    ``"pallas"``) so that a spec dict round-trips into the reference
    package unchanged.  The port ignores it: a run records the kernel
    route it took in ``extras["kernel_backend"]`` (``"cuda"`` on the card,
    ``"torch-cpu"`` on the CPU).

    ``host_groups`` / ``dcn_penalty`` make the scoring pass hierarchy-aware
    (arXiv:2103.12594-style locality scoring on top of 2PS-L's two-phase
    restreaming): with ``host_groups=H`` the k partitions are laid out on H
    host groups of k/H partitions each (partition ``p`` lives on host
    ``p // (k/H)`` — the same contiguous layout as
    ``repro.dist.multihost.normalize_host_groups``), and during scoring a
    candidate partition pays ``dcn_penalty`` per endpoint that has no
    replica anywhere on the candidate's host group.  ``dcn_penalty=0`` (the
    default) is bit-identical to flat scoring; ``host_groups`` alone still
    reports the cross-host replication factor without changing any
    assignment.  Only the stateful scorers (2PS-L family, HDRF family)
    honor the penalty — the hash partitioners reject a nonzero one.

    Example (round-trips through JSON, as every spec does; see
    docs/multihost.md for the full hierarchy story)::

        spec = TwoPSLSpec(host_groups=2, dcn_penalty=1.0)
        assert spec.algorithm == "2psl"
        assert spec_from_dict(spec.to_dict()) == spec
    """

    alpha: float = 1.05
    chunk_size: int = 1 << 16
    pipeline_depth: int = 2
    scoring_backend: str = "jnp"   # 'jnp' | 'pallas'
    host_groups: int | None = None  # H host groups of k/H partitions each
    dcn_penalty: float = 0.0       # score penalty per off-host endpoint

    def __post_init__(self):
        self.validate()

    # -- validation ------------------------------------------------------
    def validate(self):
        _check(isinstance(self.alpha, (int, float)) and self.alpha >= 1.0,
               f"alpha must be >= 1.0 (got {self.alpha!r})")
        _check(isinstance(self.chunk_size, int) and self.chunk_size > 0,
               f"chunk_size must be a positive int (got {self.chunk_size!r})")
        _check(isinstance(self.pipeline_depth, int) and self.pipeline_depth >= 1,
               f"pipeline_depth must be an int >= 1 "
               f"(got {self.pipeline_depth!r})")
        _check(self.scoring_backend in ("jnp", "pallas"),
               f"scoring_backend must be 'jnp' or 'pallas' "
               f"(got {self.scoring_backend!r})")
        _check(self.host_groups is None
               or (isinstance(self.host_groups, int) and self.host_groups >= 1),
               f"host_groups must be None or an int >= 1 "
               f"(got {self.host_groups!r})")
        _check(isinstance(self.dcn_penalty, (int, float))
               and self.dcn_penalty >= 0.0,
               f"dcn_penalty must be >= 0 (got {self.dcn_penalty!r})")
        _check(self.dcn_penalty == 0.0 or self.host_groups is not None,
               "dcn_penalty > 0 needs host_groups set (the penalty is "
               "defined per host group)")

    # -- identity --------------------------------------------------------
    @property
    def algorithm(self) -> str:
        """Canonical registry key (e.g. '2psl', 'greedy')."""
        raise NotImplementedError

    @property
    def display_name(self) -> str:
        """Human-readable name used in results/reports."""
        raise NotImplementedError

    # -- harness introspection -------------------------------------------
    @property
    def enforces_capacity(self) -> bool:
        """True when the admission path guarantees the paper's hard
        per-partition cap ``capacity(|E|, k, alpha)`` at the SPEC's alpha.
        The cross-spec test harness asserts the bound exactly for specs
        that claim it — new specs declare it here instead of being
        hand-listed in the tests."""
        return True

    def with_test_geometry(self, chunk_size: int) -> "PartitionerSpec":
        """Scale every stream-geometry knob for a small test stream.

        The cross-spec harness and the CLI crash drills run each
        registered spec over a few-thousand-edge graph; a spec whose
        geometry is expressed in absolute edge counts (buffer windows,
        byte budgets) must shrink those knobs alongside ``chunk_size`` so
        the small stream still exercises several chunks/windows and a
        hybrid in/out-of-memory boundary.  Subclasses with such knobs
        override — this is the ONE hook that lets new specs join every
        registry-introspecting suite with zero per-spec special-casing."""
        return self.replace(chunk_size=chunk_size)

    # -- serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        d = {"algorithm": self.algorithm}
        d.update(dataclasses.asdict(self))
        return d

    def replace(self, **overrides) -> "PartitionerSpec":
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class TwoPSLSpec(PartitionerSpec):
    """2PS-L (the paper) and its 2PS-HDRF variant (``scoring='hdrf'``)."""

    cluster_passes: int = 1
    max_vol_factor: float = 1.0
    scoring: str = "2psl"          # '2psl' | 'hdrf' (phase-2 step-3 scorer)
    hdrf_lambda: float = 1.1       # only used when scoring == 'hdrf'

    def validate(self):
        super().validate()
        _check(isinstance(self.cluster_passes, int)
               and self.cluster_passes >= 1,
               f"cluster_passes must be >= 1 (got {self.cluster_passes!r})")
        _check(self.max_vol_factor > 0,
               f"max_vol_factor must be > 0 (got {self.max_vol_factor!r})")
        _check(self.scoring in ("2psl", "hdrf"),
               f"scoring must be '2psl' or 'hdrf' (got {self.scoring!r})")
        _check(self.hdrf_lambda > 0,
               f"hdrf_lambda must be > 0 (got {self.hdrf_lambda!r})")

    @property
    def algorithm(self) -> str:
        return "2psl" if self.scoring == "2psl" else "2ps-hdrf"

    @property
    def display_name(self) -> str:
        return "2PS-L" if self.scoring == "2psl" else "2PS-HDRF"


@dataclass(frozen=True)
class HDRFSpec(PartitionerSpec):
    """HDRF (degree-weighted) / PowerGraph Greedy (``degree_weighted=False``)
    — the O(|E|*k) stateful streaming baselines."""

    chunk_size: int = 1 << 13
    lam: float = 1.1
    use_cap: bool = False
    degree_weighted: bool = True
    name: str | None = None        # display-name override

    #: micro-batch width of the scan inside the HDRF chunk kernel — the
    #: chunk must tile evenly so partition-size staleness stays bounded.
    MICRO_BATCH: ClassVar[int] = 64

    def validate(self):
        super().validate()
        _check(self.lam > 0, f"lam must be > 0 (got {self.lam!r})")
        _check(self.chunk_size % self.MICRO_BATCH == 0,
               f"HDRF chunk_size must be a multiple of {self.MICRO_BATCH} "
               f"(got {self.chunk_size!r})")

    @property
    def enforces_capacity(self) -> bool:
        return self.use_cap

    @property
    def algorithm(self) -> str:
        return "hdrf" if self.degree_weighted else "greedy"

    @property
    def display_name(self) -> str:
        if self.name is not None:
            return self.name
        return "HDRF" if self.degree_weighted else "Greedy"


@dataclass(frozen=True)
class DBHSpec(PartitionerSpec):
    """Degree-based hashing (Xie et al.): one degree pass, then stateless
    hashing of the lower-degree endpoint."""

    chunk_size: int = 1 << 18

    def validate(self):
        super().validate()
        _check(self.dcn_penalty == 0.0,
               "DBH hashes instead of scoring — it cannot honor a "
               "dcn_penalty (host_groups alone is fine: it only adds the "
               "cross-host replication metric)")

    @property
    def enforces_capacity(self) -> bool:
        return False

    @property
    def algorithm(self) -> str:
        return "dbh"

    @property
    def display_name(self) -> str:
        return "DBH"


@dataclass(frozen=True)
class StatelessSpec(PartitionerSpec):
    """Pure hashing partitioners needing no vertex state at all."""

    chunk_size: int = 1 << 18
    variant: str = "random"        # 'random' | 'grid'

    def validate(self):
        super().validate()
        _check(self.variant in ("random", "grid"),
               f"variant must be 'random' or 'grid' (got {self.variant!r})")
        _check(self.dcn_penalty == 0.0,
               "stateless partitioners hash instead of scoring — they "
               "cannot honor a dcn_penalty (host_groups alone is fine: it "
               "only adds the cross-host replication metric)")

    @property
    def enforces_capacity(self) -> bool:
        return False

    @property
    def algorithm(self) -> str:
        return self.variant

    @property
    def display_name(self) -> str:
        return {"random": "Random", "grid": "Grid"}[self.variant]


@dataclass(frozen=True)
class HEPSpec(PartitionerSpec):
    """Hybrid edge partitioner (arXiv:2103.12594-style): pin the replication
    state of the top-degree vertices in memory under an explicit byte
    budget, score edges touching that hot core by NE-style replica
    affinity, and route everything else through the stateless DBH hash
    that needs no per-vertex state at all.

    ``memory_budget_bytes`` bounds the partitioner's resident scoring
    state: each pinned vertex costs one packed bit-matrix row of
    ``ceil(k/32) * 4`` bytes, and the hot set is the top
    ``memory_budget_bytes // row_bytes`` vertices of the degree pass.  The
    ``engine.replication_state_bytes`` gauge reports exactly this pinned
    footprint for HEP runs, so tests and benchmarks can assert the budget
    is respected."""

    chunk_size: int = 1 << 16
    memory_budget_bytes: int = 1 << 26

    def validate(self):
        super().validate()
        _check(isinstance(self.memory_budget_bytes, int)
               and self.memory_budget_bytes >= 0,
               f"memory_budget_bytes must be an int >= 0 "
               f"(got {self.memory_budget_bytes!r})")
        _check(self.dcn_penalty == 0.0,
               "HEP's hash fallback cannot honor a dcn_penalty "
               "(host_groups alone is fine: it only adds the cross-host "
               "replication metric)")

    @property
    def algorithm(self) -> str:
        return "hep"

    @property
    def display_name(self) -> str:
        return "HEP"

    def with_test_geometry(self, chunk_size: int) -> "PartitionerSpec":
        # a tiny budget (128 rows at k <= 32) keeps the test graphs'
        # hot/cold boundary inside the vertex range, so both the in-memory
        # and the hash path are exercised
        return self.replace(chunk_size=chunk_size, memory_budget_bytes=512)


@dataclass(frozen=True)
class BufferedSpec(PartitionerSpec):
    """Buffered re-streaming (arXiv:2402.11980-style): accumulate a window
    of ``buffer_edges`` edges, build an in-memory mini-graph of the window,
    cluster it, and partition the whole batch with 2PS-L's two-candidate
    scoring against the global replication state before flushing.

    The engine regroups the stream into windows of
    ``window_chunks * chunk_size`` edges (``buffer_edges`` rounded up to
    whole chunks), so the existing depth-N pipeline overlaps the next
    window's buffer fill with the current window's clustering + device
    scoring.  Checkpoints land at window boundaries — a window is the
    atomic unit of work, so mid-window state never needs snapshotting."""

    chunk_size: int = 1 << 14
    buffer_edges: int = 1 << 16
    max_vol_factor: float = 1.0    # window-local cluster volume cap factor

    def validate(self):
        super().validate()
        _check(isinstance(self.buffer_edges, int) and self.buffer_edges >= 1,
               f"buffer_edges must be a positive int "
               f"(got {self.buffer_edges!r})")
        _check(self.max_vol_factor > 0,
               f"max_vol_factor must be > 0 (got {self.max_vol_factor!r})")
        _check(self.dcn_penalty == 0.0,
               "buffered re-streaming scores within windows and is not yet "
               "hierarchy-aware — it cannot honor a dcn_penalty "
               "(host_groups alone is fine: it only adds the cross-host "
               "replication metric)")

    @property
    def window_chunks(self) -> int:
        """Engine chunks per buffer window (``buffer_edges`` rounded up)."""
        return max(1, -(-self.buffer_edges // self.chunk_size))

    @property
    def algorithm(self) -> str:
        return "buffered"

    @property
    def display_name(self) -> str:
        return "Buffered"

    def with_test_geometry(self, chunk_size: int) -> "PartitionerSpec":
        # two chunks per window: small streams still see several windows
        # AND the window/chunk regrouping is genuinely exercised
        return self.replace(chunk_size=chunk_size,
                            buffer_edges=2 * chunk_size)


# ---------------------------------------------------------------------------
# registry: canonical name -> (spec class, presets)
# ---------------------------------------------------------------------------

SPEC_REGISTRY: dict[str, tuple[type, dict]] = {
    "2psl": (TwoPSLSpec, {}),
    "2ps-hdrf": (TwoPSLSpec, {"scoring": "hdrf"}),
    "hdrf": (HDRFSpec, {}),
    "greedy": (HDRFSpec, {"degree_weighted": False}),
    "dbh": (DBHSpec, {}),
    "grid": (StatelessSpec, {"variant": "grid"}),
    "random": (StatelessSpec, {"variant": "random"}),
    "hep": (HEPSpec, {}),
    "buffered": (BufferedSpec, {}),
}


def spec_for(name: str, **overrides) -> PartitionerSpec:
    """Build the canonical spec for a registered algorithm name, applying
    keyword overrides on top of the name's presets.

    Example::

        spec_for("2ps-hdrf")                      # TwoPSLSpec(scoring='hdrf')
        spec_for("2psl", alpha=1.1, host_groups=2, dcn_penalty=1.0)
        spec_for("nope")                          # raises SpecError
    """
    try:
        cls, presets = SPEC_REGISTRY[name]
    except KeyError:
        raise SpecError(f"unknown partitioner {name!r}; known: "
                        f"{sorted(SPEC_REGISTRY)}") from None
    return cls(**{**presets, **overrides})


def spec_from_dict(d: dict) -> PartitionerSpec:
    """Inverse of ``PartitionerSpec.to_dict`` (manifest deserialization)."""
    d = dict(d)
    try:
        name = d.pop("algorithm")
    except KeyError:
        raise SpecError("spec dict is missing the 'algorithm' key") from None
    if name not in SPEC_REGISTRY:
        raise SpecError(f"unknown partitioner {name!r}; known: "
                        f"{sorted(SPEC_REGISTRY)}")
    cls, presets = SPEC_REGISTRY[name]
    return cls(**{**presets, **d})
