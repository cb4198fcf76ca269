"""Batched genome evaluation: EvalEngine + cross-cell EvalCache + executors.

The paper's GA measures each distinct offload pattern once in a verification
environment (§4.1.2). This module generalizes that guarantee from "once per
GA run" to "once per fleet sweep": an :class:`EvalEngine` owns a persistent,
thread-safe :class:`EvalCache` shared across every ``(arch × shape × mesh)``
cell, and a pluggable executor that dispatches the *uncached* genomes of a
whole GA generation as one batch:

* :class:`SerialExecutor`     — measure genomes one by one (the seed behavior).
* :class:`ThreadedExecutor`   — thread-pool fan-out, for measurement backends
  that release the GIL or wait on subprocesses (XLA compiles, real hardware
  probes).
* :class:`VectorizedExecutor` — hand the whole batch to a closed-form
  batch-measure function (the analytic cost model evaluates a generation in
  one call, sharing the per-cell unit-cost invariants across genomes).

Cache keys are *semantic*: callers may pass a ``canonical`` function mapping a
genome to the payload that actually determines the measurement (for LM cells:
arch, shape, mesh, resolved Decisions). Distinct genomes or distinct fleet
cells that resolve to the same payload then share one measurement — e.g. a
cell's CPU-baseline ``Decisions()`` and its all-defaults seed genome, or
multi-start GA restarts of the same cell under different seeds.

Executors only change *where* measurements run, never *what* is measured:
``run_ga`` is deterministic in its results for any executor choice because
measurement backends are pure functions of the genome and the GA's RNG stream
never observes the executor. Under concurrent fleet sweeps two cells may race
to measure the same payload; both compute the same value and the cache keeps
one — the "measured once" guarantee is per cell, at-most-twice fleet-wide.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor as _FuturesPool
from dataclasses import dataclass, field
from typing import Callable, Hashable, Optional, Protocol, Sequence

from repro_torch.core.fitness import Measurement

Genome = tuple[int, ...]
MeasureFn = Callable[[Genome], Measurement]
CanonicalFn = Callable[[Genome], Hashable]


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CacheStats:
    """Monotonic counters; diff two snapshots to scope stats to one sweep."""

    lookups: int = 0
    hits: int = 0
    cross_cell_hits: int = 0  # hit on an entry inserted by a *different* cell
    inserts: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def since(self, base: "CacheStats") -> "CacheStats":
        return CacheStats(self.lookups - base.lookups, self.hits - base.hits,
                          self.cross_cell_hits - base.cross_cell_hits,
                          self.inserts - base.inserts)


class EvalCache:
    """Thread-safe measurement cache shared across cells and GA runs.

    Subclass hooks:

    * ``_key`` canonicalizes a caller key before storage/lookup — a
      disk-backed cache maps arbitrary Hashables to stable strings so
      entries survive process boundaries (see core/cache_store.py).
    * ``_on_insert`` observes every first-time insert — the persistence
      point; the base cache keeps everything in memory only. It is called
      AFTER the cache lock is released (the race-lint's blocking-under-lock
      rule: a persistence hook doing disk I/O inside the hot cache lock
      stalls every concurrent ``get``). The insert decision itself is made
      under the lock, so the hook still fires exactly once per key.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._data: dict[Hashable, tuple[str, Measurement]] = {}
        self._lookups = 0
        self._hits = 0
        self._cross = 0
        self._inserts = 0

    def _key(self, key: Hashable) -> Hashable:
        return key

    def _on_insert(self, key: Hashable, cell: str, m: Measurement) -> None:
        pass

    def preload(self, entries: dict[Hashable, tuple[str, Measurement]]) -> None:
        """Seed entries (already in ``_key`` form) without touching the
        lookup/insert counters: preloaded state is history, not traffic."""
        with self._lock:
            for k, rec in entries.items():
                self._data.setdefault(k, rec)

    def get(self, key: Hashable, cell: str) -> Optional[Measurement]:
        key = self._key(key)
        with self._lock:
            self._lookups += 1
            rec = self._data.get(key)
            if rec is None:
                return None
            self._hits += 1
            if rec[0] != cell:
                self._cross += 1
            return rec[1]

    def put(self, key: Hashable, cell: str, m: Measurement) -> None:
        key = self._key(key)
        with self._lock:
            inserted = key not in self._data  # first writer wins
            if inserted:
                self._data[key] = (cell, m)
                self._inserts += 1
        if inserted:
            self._on_insert(key, cell, m)

    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(self._lookups, self._hits, self._cross,
                              self._inserts)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------


class BatchExecutor(Protocol):
    name: str

    def run(self, measure: MeasureFn, genomes: Sequence[Genome]
            ) -> list[Measurement]: ...


class SerialExecutor:
    """One measurement at a time, in batch order (seed-equivalent)."""

    name = "serial"

    def run(self, measure: MeasureFn, genomes: Sequence[Genome]
            ) -> list[Measurement]:
        return [measure(g) for g in genomes]


class ThreadedExecutor:
    """Thread-pool fan-out; order-preserving. Worth it when ``measure``
    blocks outside the GIL (compiles, subprocesses, device waits). One
    persistent pool serves every batch — per-generation pool churn would be
    pure overhead; idle workers are reclaimed at interpreter shutdown."""

    name = "thread"

    def __init__(self, max_workers: int = 8) -> None:
        self.max_workers = max_workers
        self._pool: Optional[_FuturesPool] = None
        self._pool_lock = threading.Lock()

    def _get_pool(self) -> _FuturesPool:
        with self._pool_lock:
            if self._pool is None:
                self._pool = _FuturesPool(max_workers=self.max_workers)
            return self._pool

    def run(self, measure: MeasureFn, genomes: Sequence[Genome]
            ) -> list[Measurement]:
        if len(genomes) <= 1:
            return [measure(g) for g in genomes]
        return list(self._get_pool().map(measure, genomes))


class VectorizedExecutor:
    """Dispatch the whole batch to a closed-form batch-measure function:
    the ``.batch`` attribute (``genomes -> list[Measurement]``) that a
    backend attaches to its measure callable, as the analytic LM backend
    does. The hook travels *on the measure function* — never on this
    executor — so one vectorized engine serves every cell of a fleet and a
    cell's batch function can never be applied to another cell's genomes.
    Measures without a hook fall back to serial measurement."""

    name = "vectorized"

    def run(self, measure: MeasureFn, genomes: Sequence[Genome]
            ) -> list[Measurement]:
        batch = getattr(measure, "batch", None)
        if batch is None:
            return [measure(g) for g in genomes]
        out = list(batch(genomes))
        assert len(out) == len(genomes), "batch measure must be aligned"
        return out


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Measurement-backend registry
# ---------------------------------------------------------------------------

# Fleet cells default to the analytic cost model; named backends let a
# CellSpec opt into a different verification environment (compile-backed,
# metered, hardware probe) while still evaluating through the shared engine
# and cache. A factory is called with the cell's resolved context — for LM
# cells: (cfg, shape, mesh_shape, power) — and returns the cell's measure
# function. Registration is process-global so benchmark drivers and the
# telemetry layer can contribute backends without core importing them.
BackendFactory = Callable[..., MeasureFn]
_BACKENDS: dict[str, BackendFactory] = {}
_BACKENDS_LOCK = threading.Lock()


def register_backend(name: str, factory: BackendFactory, *,
                     overwrite: bool = False) -> None:
    """Register a named measurement-backend factory for fleet cells."""
    with _BACKENDS_LOCK:
        if not overwrite and name in _BACKENDS and _BACKENDS[name] is not factory:
            raise ValueError(f"backend {name!r} already registered")
        _BACKENDS[name] = factory


def get_backend(name: str) -> BackendFactory:
    with _BACKENDS_LOCK:
        try:
            return _BACKENDS[name]
        except KeyError:
            raise KeyError(
                f"unknown measurement backend {name!r}; registered: "
                f"{sorted(_BACKENDS)}") from None


def backend_names() -> list[str]:
    with _BACKENDS_LOCK:
        return sorted(_BACKENDS)


@dataclass
class EvalEngine:
    """Deduplicating batch dispatcher: cache lookups first, then one executor
    call for the distinct uncached genomes, preserving the seed GA's
    measured-once accounting (first occurrence = evaluation, repeats = hits).
    """

    executor: BatchExecutor = field(default_factory=SerialExecutor)
    cache: EvalCache = field(default_factory=EvalCache)
    # Cells a static pre-screen (analysis/screen.py) dropped before they
    # reached this engine: observability for "measurements avoided", kept
    # out of CacheStats so cache accounting stays purely about lookups.
    screened_cells: list = field(default_factory=list)

    def note_screened(self, cell_keys: Sequence[str]) -> None:
        """Record cells a pre-screen dropped before any evaluate() call."""
        self.screened_cells.extend(cell_keys)

    def evaluate(
        self,
        cell: str,
        genomes: Sequence[Genome],
        measure: MeasureFn,
        canonical: Optional[CanonicalFn] = None,
    ) -> tuple[list[Measurement], int, int]:
        """Measurements aligned with ``genomes`` + (new evals, cache hits).

        ``canonical`` maps a genome to its semantic cache key; the default
        key is ``(cell, genome)`` so unrelated genome spaces never collide.
        """
        keyfn: CanonicalFn = canonical or (lambda g: (cell, g))
        keys = [keyfn(g) for g in genomes]
        found: dict[Hashable, Measurement] = {}
        pending: list[tuple[Hashable, Genome]] = []
        pending_keys: set[Hashable] = set()
        evals = hits = 0
        for key, g in zip(keys, genomes):
            if key in pending_keys:
                hits += 1  # duplicate within this batch: measured once
                continue
            m = self.cache.get(key, cell)
            if m is not None:
                hits += 1
                found[key] = m
            else:
                pending_keys.add(key)
                pending.append((key, g))
        if pending:
            measured = self.executor.run(measure, [g for _, g in pending])
            for (key, _), m in zip(pending, measured):
                self.cache.put(key, cell, m)
                found[key] = m
                evals += 1
        return [found[key] for key in keys], evals, hits
