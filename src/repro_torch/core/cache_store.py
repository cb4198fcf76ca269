"""Disk persistence for the cross-cell :class:`EvalCache` (ROADMAP item 3).

The in-memory cache makes a fleet sweep incremental *within* one engine
lifetime; this module makes it incremental *across processes*: every
first-time measurement is appended to a JSONL file under ``results/`` and a
fresh engine constructed over the same file starts with the whole history —
a repeated sweep then performs zero new measurements (the paper's
"each distinct pattern measured once", extended to the deployment's whole
history of sweeps).

Keys are arbitrary Hashables in memory (tuples of frozen dataclasses for the
semantic LM keys). On disk they become :func:`stable_key` strings — ``repr``
of the key, which is deterministic across processes for the tuples, frozen
dataclasses, strings, ints and floats these keys are built from (no
id-based reprs, no hash randomization exposure). Two processes therefore
agree on every key, and a measurement made by one is a hit for the other.

Durability model: each append is ONE ``os.write`` of the whole line to an
``O_APPEND`` file descriptor — POSIX makes that atomic w.r.t. every
concurrent reader and appender (no interleaved halves, no buffered tail
sitting in userspace), so a :meth:`CacheStore.load` racing an append sees
either the complete line or nothing. A crash can at worst truncate the
final line; ``load`` skips undecodable lines, so a torn tail costs one
re-measurement, never a corrupt cache. The store's lock only guards the
lazy fd open/close and the compaction swap — never I/O (the race-lint's
lock-blocking rule pins this).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Hashable, Optional

from repro_torch.core.evaluator import EvalCache
from repro_torch.core.fitness import Measurement


def stable_key(key: Hashable) -> str:
    """Deterministic cross-process string form of a cache key."""
    return repr(key)


# ---------------------------------------------------------------------------
# Measurement <-> JSON
# ---------------------------------------------------------------------------


def measurement_to_json(m: Measurement) -> dict:
    out = {
        "time_s": m.time_s,
        "energy_ws": m.energy_ws,
        "timed_out": m.timed_out,
        "feasible": m.feasible,
        "avg_watts": m.avg_watts,
    }
    if m.detail is not None:
        try:
            json.dumps(m.detail)
            out["detail"] = m.detail
        except (TypeError, ValueError):
            # detail is advisory; never let an exotic payload block persistence
            out["detail"] = None
    return out


def measurement_from_json(d: dict) -> Measurement:
    return Measurement(
        time_s=d["time_s"],
        energy_ws=d["energy_ws"],
        timed_out=d.get("timed_out", False),
        feasible=d.get("feasible", True),
        avg_watts=d.get("avg_watts"),
        detail=d.get("detail"),
    )


# ---------------------------------------------------------------------------
# JSONL store
# ---------------------------------------------------------------------------


class CacheStore:
    """Append-only JSONL file of ``{"key", "cell", "m"}`` records."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._fd: Optional[int] = None  # O_APPEND fd, lazily opened
        self._appends = 0  # lifetime appends; compaction races abort on it
        self.dropped_on_load = 0  # duplicate/torn lines seen by the last load

    def load(self, *, compact: bool = False
             ) -> dict[str, tuple[str, Measurement]]:
        """All decodable records, last-writer-wins per key (duplicates can
        only carry identical measurements, so the order is immaterial).

        ``compact=True`` additionally rewrites the file once — one line per
        surviving key, superseded duplicates and torn lines dropped — when
        the load found anything to drop. Two appenders racing on one key
        (the cache's at-most-twice fleet-wide case) and repeated crash-torn
        tails otherwise grow a long-lived ``results/`` file without bound
        across re-sweeps. The rewrite is write-temp-then-rename, so a crash
        mid-compaction leaves either the old or the new file, never a mix.

        Compaction vs a concurrent appender *in this process*: the rewrite
        snapshots the lifetime append counter before reading and aborts the
        swap (keeping the append-only file intact) if any append lands
        in between — an appender can never lose a line to a racing
        ``compact()``. A concurrent appender in ANOTHER process is still
        invisible: its lines written after this read are dropped by the
        rename, and its O_APPEND fd keeps writing to the unlinked inode.
        That costs re-measurements, never correctness (every record is
        reproducible), but deployments with concurrent cross-process
        writers should construct ``PersistentEvalCache(..., compact=False)``
        and compact offline.
        """
        entries: dict[str, tuple[str, Measurement]] = {}
        lines = 0
        with self._lock:
            appends_seen = self._appends
        if not os.path.exists(self.path):
            return entries
        with open(self.path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                lines += 1
                try:
                    rec = json.loads(line)
                    entries[rec["key"]] = (rec.get("cell", ""),
                                           measurement_from_json(rec["m"]))
                except (json.JSONDecodeError, KeyError, TypeError):
                    continue  # torn/foreign line: skip, re-measure later
        self.dropped_on_load = lines - len(entries)
        if compact and self.dropped_on_load > 0:
            self._rewrite(entries, expected_appends=appends_seen)
        return entries

    def _rewrite(self, entries: dict[str, tuple[str, Measurement]], *,
                 expected_appends: int) -> bool:
        """Write-temp-then-rename swap; the tmp file is written OUTSIDE the
        lock (blocking I/O under the store lock would stall every appender
        for the whole rewrite) and the swap aborts if an append raced the
        compaction — the append-only log is then left untouched."""
        tmp = self.path + ".compact.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for key, (cell, m) in entries.items():
                fh.write(json.dumps({"key": key, "cell": cell,
                                     "m": measurement_to_json(m)}) + "\n")
        with self._lock:
            if self._appends != expected_appends:
                swapped = False  # an appender raced us: keep the full log
            else:
                if self._fd is not None:  # reopen after the swap
                    os.close(self._fd)
                    self._fd = None
                os.replace(tmp, self.path)
                swapped = True
        if not swapped:
            os.unlink(tmp)
            self.dropped_on_load = 0  # nothing was actually dropped
        return swapped

    def compact(self) -> int:
        """Deduplicate the file in place; returns the lines dropped."""
        self.load(compact=True)
        return self.dropped_on_load

    def _append_fd(self) -> int:
        """The lazily-opened O_APPEND descriptor (lock only guards open)."""
        with self._lock:
            if self._fd is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._fd = os.open(self.path,
                                   os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                                   0o644)
            self._appends += 1
            return self._fd

    def append(self, key: str, cell: str, m: Measurement) -> None:
        line = json.dumps({"key": key, "cell": cell,
                           "m": measurement_to_json(m)})
        # one os.write of the full line: POSIX O_APPEND makes it atomic
        # w.r.t. concurrent load() readers and other appenders — and it
        # happens outside the lock, so a slow disk never serializes the
        # fleet behind the store
        os.write(self._append_fd(), (line + "\n").encode("utf-8"))

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None


# ---------------------------------------------------------------------------
# Disk-backed cache
# ---------------------------------------------------------------------------


class PersistentEvalCache(EvalCache):
    """An :class:`EvalCache` whose inserts stream to a :class:`CacheStore`
    and whose constructor replays the store — pass it to an ``EvalEngine``
    and every ``search_fleet`` sweep in every process shares one measurement
    history. Preloaded entries do not count as inserts, so a re-sweep's
    ``FleetResult.evaluations`` is exactly the number of *new* measurements
    (0 for a repeat sweep). Construction compacts the append-only file when
    it has accumulated superseded duplicates or torn lines (``compact=False``
    opts out), so long-lived caches stop growing unboundedly across
    re-sweeps."""

    def __init__(self, path: str, *, store: Optional[CacheStore] = None,
                 compact: bool = True) -> None:
        super().__init__()
        self.store = store or CacheStore(path)
        loaded = self.store.load(compact=compact)
        self.preload(loaded)
        self.preloaded = len(loaded)
        self.compacted_lines = self.store.dropped_on_load if compact else 0

    def _key(self, key: Hashable) -> str:
        return key if isinstance(key, str) else stable_key(key)

    def _on_insert(self, key: Hashable, cell: str, m: Measurement) -> None:
        self.store.append(key, cell, m)
