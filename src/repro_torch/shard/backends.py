"""State-exchange backends for sharded partitioning: the reference
package's ``shard/backends.py``, with ``torch.distributed`` in the place of
``jax.distributed``.

A backend is anything with ``.rank``, ``.world``, and
``exchange(key, state) -> [ShardState] * world`` — an all-gather at a
named rendezvous point (``p<pass>_r<round>`` or ``final``).  Three
implementations, cheapest first:

* ``ThreadExchange`` — all workers are threads of one process; states
  move through a dict guarded by a condition variable.  This is the
  **emulated** backend: ``run_worker`` executes the exact same code
  against it as against the multi-process backends.
* ``FileExchange`` — each worker is its own process; states are
  published as atomically-renamed ``.npz`` files in a shared directory
  and peers poll for them.  No coordinator, no sockets — works anywhere
  a shared filesystem does (which out-of-core partitioning already
  assumes for the graph itself).  Its files are the reference's, so
  workers of the two packages can share one directory.
* ``TorchDistributedExchange`` — a FileExchange whose rank and world come
  from a ``torch.distributed`` process group (gloo), which it initializes
  from an ``init_method`` (``tcp://host:port``, or ``env://``) unless one
  is already up.  The bulk state still moves through the shared
  directory: the O(|V|) states merge in host numpy, so a collective on
  the card (NCCL) would only add a copy to the device.

Every backend is deterministic in *content*: merges are commutative and
associative (``StreamingPartitioner.merge_rules``), so arrival order
never matters.
"""
from __future__ import annotations

import os
import threading
import time

from .state import ShardState

__all__ = ["ExchangeTimeout", "FileExchange", "ThreadExchange",
           "TorchDistributedExchange"]


class ExchangeTimeout(RuntimeError):
    """A rendezvous did not complete in time (a peer died or stalled)."""


class ThreadExchange:
    """In-process hub: create once with the world size, hand each worker
    thread its ``for_rank(r)`` view.  ``abort(exc)`` wakes every waiter
    with the failure so one dead worker cannot hang the rest."""

    def __init__(self, world: int, *, timeout_s: float = 120.0):
        self.world = int(world)
        self.timeout_s = float(timeout_s)
        self._slots: dict = {}      # key -> {rank: ShardState}
        self._reads: dict = {}      # key -> ranks done collecting
        self._cv = threading.Condition()
        self._exc: BaseException | None = None

    def abort(self, exc: BaseException) -> None:
        with self._cv:
            if self._exc is None:
                self._exc = exc
            self._cv.notify_all()

    def for_rank(self, rank: int) -> "_ThreadExchangeView":
        return _ThreadExchangeView(self, int(rank))

    def _exchange(self, rank: int, key: str, state: ShardState):
        deadline = time.monotonic() + self.timeout_s
        with self._cv:
            self._slots.setdefault(key, {})[rank] = state
            self._cv.notify_all()
            while len(self._slots.get(key, ())) < self.world:
                if self._exc is not None:
                    raise RuntimeError(
                        f"exchange {key!r} aborted: peer failed"
                    ) from self._exc
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(remaining):
                    raise ExchangeTimeout(
                        f"rank {rank}: exchange {key!r} incomplete after "
                        f"{self.timeout_s:.0f}s "
                        f"({len(self._slots[key])}/{self.world} states)")
            states = [self._slots[key][r] for r in range(self.world)]
            done = self._reads.setdefault(key, set())
            done.add(rank)
            if len(done) == self.world:     # last reader frees the slot
                del self._slots[key], self._reads[key]
        return states


class _ThreadExchangeView:
    def __init__(self, hub: ThreadExchange, rank: int):
        self._hub = hub
        self.rank = rank
        self.world = hub.world

    def exchange(self, key: str, state: ShardState):
        return self._hub._exchange(self.rank, key, state)


class FileExchange:
    """Shared-directory all-gather: publish ``<key>_w<rank>.npz``
    atomically, poll until every peer's file exists, load them all.
    Files persist after the rendezvous — that is a feature: a worker
    resuming from a checkpoint mid-pass finds its peers' earlier rounds
    still on disk and re-joins without any replay protocol."""

    def __init__(self, directory: str, rank: int, world: int, *,
                 timeout_s: float = 300.0, poll_s: float = 0.05):
        self.directory = directory
        self.rank = int(rank)
        self.world = int(world)
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str, rank: int) -> str:
        return os.path.join(self.directory, f"{key}_w{rank:03d}.npz")

    def exchange(self, key: str, state: ShardState):
        state.save(self._path(key, self.rank))
        deadline = time.monotonic() + self.timeout_s
        states = []
        for r in range(self.world):
            path = self._path(key, r)
            while not os.path.exists(path):
                if time.monotonic() > deadline:
                    raise ExchangeTimeout(
                        f"rank {self.rank}: no state from rank {r} at "
                        f"{path} after {self.timeout_s:.0f}s")
                time.sleep(self.poll_s)
            states.append(ShardState.load(path))
        return states


class TorchDistributedExchange(FileExchange):
    """FileExchange whose rank/world come from a ``torch.distributed``
    process group (real multi-process launches, one card or many).  The
    group provides identity and lifetime; bulk state still rides the
    shared directory — the O(|V|) state per round is filesystem-cheap next
    to the O(|E|) stream every worker is already reading from it, and a
    run exchanges the same files as an ``fs`` run.

    The group is gloo's: it carries no tensor, so it needs no card.
    Unless a group is already initialized, ``init_process_group`` gets
    ``init_method`` (``tcp://host:port``; ``env://`` when None, reading
    ``MASTER_ADDR``/``MASTER_PORT``, and ``RANK``/``WORLD_SIZE`` where
    ``rank``/``world_size`` are None)."""

    def __init__(self, directory: str, *, init_method=None,
                 world_size=None, rank=None, timeout_s: float = 300.0,
                 poll_s: float = 0.05):
        import datetime

        import torch.distributed as dist
        if not dist.is_available():
            raise RuntimeError(
                "this torch build has no torch.distributed; use the 'fs' "
                "backend (FileExchange) instead")
        self._owns_group = not dist.is_initialized()
        if self._owns_group:
            try:
                dist.init_process_group(
                    "gloo", init_method=init_method or "env://",
                    world_size=-1 if world_size is None else int(world_size),
                    rank=-1 if rank is None else int(rank),
                    timeout=datetime.timedelta(seconds=timeout_s))
            except Exception as e:
                raise RuntimeError(
                    "torch.distributed.init_process_group failed — set "
                    "--coordinator (a tcp://host:port init_method, or "
                    "env:// with MASTER_ADDR/MASTER_PORT), --workers and "
                    "--rank, or use --backend fs") from e
        super().__init__(directory, rank=dist.get_rank(),
                         world=dist.get_world_size(), timeout_s=timeout_s,
                         poll_s=poll_s)

    def close(self) -> None:
        """Leave the process group this exchange initialized (a group that
        was up before it stays)."""
        import torch.distributed as dist
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self._owns_group = False
