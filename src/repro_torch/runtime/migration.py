"""Mid-flight migration of admitted requests across engines.

Counterpart of the JAX package's ``runtime/migration.py``, with the same
contract:

* :func:`snapshot_slot` copies ONE slot's share of a live engine's decode
  state to the host — per-slot KV rows, recurrent RWKV/Mamba/hybrid
  leaves, the per-slot position, the request, its cursor and its effective
  length cap — into a :class:`SlotSnapshot`. Its leaves are CPU tensors
  (numpy has no bfloat16), copies rather than views of the live state,
  which the port's engine updates in place.
* :func:`restore_slot` reshapes the snapshot onto the target's geometry —
  cache-length leaves (``models/transformer.decode_state_cache_keys``) are
  padded/truncated with :func:`~repro_torch.checkpoint.checkpointer.
  resize_axis` when ``max_len`` disagrees; truncation is safe because the
  per-row causal mask makes rows at index >= pos unreachable — and writes
  it into a free slot in place (``models/transformer.restore_decode_slot``):
  the target's other slots keep decoding.
* :func:`migrate` is the transactional move (snapshot → restore → detach,
  in an order that leaves the source untouched when the target refuses).

Billing contract (no token billed twice): tokens decoded before the move
bill under the slot's epoch on the source; tokens after the move bill under
the **target's** placement epoch captured at restore. The move itself bills
as a separate transfer-cost ledger line (``EngineStats.migration_ws`` =
snapshot bytes x ``transfer_ws_per_mib``, charged to the receiving engine).
``admissions`` is not re-counted; ``migrations_in``/``migrations_out``
record the events.

The snapshot carries the slot's **cap** (``max_len`` of the admitting
engine, chained through re-migration), so a request moved to a roomier
engine still length-caps exactly where its never-migrated baseline would.

Deterministic refusals (:class:`MigrationError`), raised before either
engine's state is modified: a sliding-window ring whose length differs
between engines (ring phase is length-dependent), a target cache too short
for the rows the request can still address, a tampered manifest, no free
slot, a non-awake target without a clock to wake-charge it, or a wake whose
latency has not elapsed.

Thread-safety: single-writer, as ``ServingEngine``: migration mutates both
engines, so the caller must own both.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.checkpoint.checkpointer import _digest, resize_axis, \
    tree_paths
from repro_torch.models import transformer as T
from repro_torch.runtime.serving import Request, ServingEngine

# Default transfer-cost rate: Watt·s charged per MiB of snapshot moved
# between destinations (interconnect + host staging). Deliberately modeled,
# like every other rate on the ledger; callers may override it.
DEFAULT_TRANSFER_WS_PER_MIB = 0.5


class MigrationError(RuntimeError):
    """A migration that cannot proceed — deterministic refusal, raised
    before either engine's state is modified."""


@dataclass
class SlotSnapshot:
    """Host-side image of one live slot.

    ``leaves`` mirrors the decode-state structure minus ``pos`` (CPU
    tensors, batch axis dropped); ``manifest``/``digest`` follow the
    checkpoint manifest convention (flat escaped leaf paths -> shape/dtype,
    sha256 digest) so integrity is checked at restore; ``cap`` is the
    effective length cap of the ADMITTING engine, preserved across
    re-migration.
    """

    request: Request
    cursor: int
    pos: int
    cap: int
    source: str  # engine name the snapshot was taken from
    source_max_len: int
    leaves: dict = field(repr=False)
    manifest: dict = field(repr=False)
    digest: str = ""
    nbytes: int = 0


def _leaf_manifest(leaves: dict) -> tuple[dict, int]:
    """Shapes, dtypes spelled as numpy spells them ("bfloat16", not
    "torch.bfloat16") and bytes: the reference's manifest for the same
    state."""
    manifest: dict[str, Any] = {}
    nbytes = 0
    for path, arr in tree_paths(leaves):
        manifest[path] = {"shape": list(arr.shape),
                          "dtype": str(arr.dtype).removeprefix("torch.")}
        nbytes += arr.numel() * arr.element_size()
    return manifest, nbytes


def _session(engine: ServingEngine) -> tuple[str, dict]:
    if engine._stream is not None:
        return "stream", engine._stream
    if engine._wave is not None:
        return "wave", engine._wave
    raise MigrationError(
        f"engine {engine.name!r} has no open session to migrate through")


def free_slots(engine: ServingEngine) -> list[int]:
    """Slot indices of the open session a snapshot could restore into
    ([] when no session is open)."""
    if engine._stream is not None:
        return [i for i, r in enumerate(engine._stream["slot_req"])
                if r is None]
    if engine._wave is not None:
        # a wave session can grow up to the engine's slot count; inactive
        # wave members keep their slot (the wave never refills them)
        return list(range(len(engine._wave["reqs"]), engine.slots))
    return []


def _cache_len(tree: Any, axis: int) -> int:
    return tree_paths(tree)[0][1].shape[axis]


def snapshot_slot(engine: ServingEngine, slot: int) -> SlotSnapshot:
    """Host-side snapshot of occupied ``slot`` in ``engine``'s open
    session. Read-only on the engine: pair with :func:`detach_slot` (or use
    :func:`migrate`) to actually move the request."""
    kind, s = _session(engine)
    if engine.power_state != "awake":
        raise MigrationError(
            f"source {engine.name!r} is {engine.power_state}; only an "
            f"awake engine's decode state is coherent to snapshot")
    if kind == "stream":
        reqs, cursors, caps = s["slot_req"], s["cursors"], s["cap"]
    else:
        reqs, cursors, caps = s["reqs"], s["cursors"], s["cap"]
        if slot < len(reqs) and not s["active"][slot]:
            raise MigrationError(
                f"slot {slot} of {engine.name!r} already finished its wave")
    if slot < 0 or slot >= len(reqs) or reqs[slot] is None:
        raise MigrationError(
            f"slot {slot} of {engine.name!r} holds no admitted request")
    leaves, pos = T.extract_decode_slot(engine.cfg, s["state"], slot)
    manifest, nbytes = _leaf_manifest(leaves)
    return SlotSnapshot(
        request=reqs[slot], cursor=cursors[slot], pos=pos, cap=caps[slot],
        source=engine.name, source_max_len=engine.max_len,
        leaves=leaves, manifest=manifest, digest=_digest(manifest),
        nbytes=nbytes)


def detach_slot(engine: ServingEngine, slot: int) -> Request:
    """Release ``slot`` on the source after its snapshot restored elsewhere:
    the slot frees (a stream slot re-admits from the queue next step), the
    request leaves ``engine.active`` and ``migrations_out`` ticks. No token
    is un-billed — everything decoded here was genuinely served here."""
    kind, s = _session(engine)
    if kind == "stream":
        req = s["slot_req"][slot]
        if req is None:
            raise MigrationError(f"slot {slot} of {engine.name!r} is free")
        s["slot_req"][slot] = None
    else:
        if slot >= len(s["reqs"]) or not s["active"][slot]:
            raise MigrationError(f"slot {slot} of {engine.name!r} is free")
        req = s["reqs"][slot]
        s["active"][slot] = False
    engine.active.remove(req)
    engine.stats.migrations_out += 1
    return req


def _check_geometry(engine: ServingEngine, snap: SlotSnapshot,
                    state: dict) -> None:
    """Deterministic refusals, all raised before any state is written."""
    cfg = engine.cfg
    req = snap.request
    if _digest(snap.manifest) != snap.digest:
        raise MigrationError("snapshot manifest digest mismatch")
    for key in T.decode_state_cache_keys(cfg):
        if key not in snap.leaves:
            raise MigrationError(
                f"snapshot is missing state key {key!r} — source and "
                f"target disagree on the model family")
        src_len = _cache_len(snap.leaves[key], 1)  # batch axis dropped
        dst_len = _cache_len(state[key], 2)  # (layers, batch, len, ...)
        if cfg.sliding_window and src_len != dst_len:
            # a ring buffer's occupancy layout is a function of its length
            # (slot = pos % length): resizing would scramble the ring
            raise MigrationError(
                f"sliding-window ring length differs ({src_len} vs "
                f"{dst_len}); refusing to rephase the ring")
        # rows the request can still address: its carried cap bounds every
        # future position, and prompt+max_new_tokens bounds the request's
        # own footprint — whichever is tighter
        needed = min(snap.cap, len(req.prompt) + req.max_new_tokens)
        if dst_len < needed:
            raise MigrationError(
                f"target cache ({dst_len} rows) cannot hold the "
                f"{needed} rows request {req.rid} can still address")


def restore_slot(engine: ServingEngine, snap: SlotSnapshot, *,
                 now: Optional[float] = None,
                 transfer_ws_per_mib: float = DEFAULT_TRANSFER_WS_PER_MIB
                 ) -> int:
    """Reshape ``snap`` onto ``engine``'s geometry and write it into a free
    slot of the open session; returns the slot index.

    Power guard (the sleep→migrate→drain path): a non-awake target without
    a clock refuses outright; with a clock the wake is initiated first
    (wake-charged: ``stats.wakes`` ticks), and the restore still refuses
    until the wake latency has elapsed, so the caller retries on a later
    tick. Either way the refusal is deterministic and the snapshot
    unconsumed.

    Post-migration tokens bill under the TARGET's placement epoch captured
    here; the transfer itself bills ``nbytes x transfer_ws_per_mib`` to the
    target's ``migration_ws`` ledger line.
    """
    if engine.power_state != "awake":
        if now is None:
            raise MigrationError(
                f"target {engine.name!r} is {engine.power_state} and no "
                f"clock was given to wake-charge it")
        engine.wake(now)
        if not engine.check_awake(now):
            raise MigrationError(
                f"target {engine.name!r} is waking until "
                f"t={engine._awake_at:.3f}; retry after the wake latency")
    kind, s = _session(engine)
    free = free_slots(engine)
    if not free:
        raise MigrationError(f"target {engine.name!r} has no free slot")
    slot = free[0]
    _check_geometry(engine, snap, s["state"])

    leaves = dict(snap.leaves)
    for key in T.decode_state_cache_keys(engine.cfg):
        dst_len = _cache_len(s["state"][key], 2)
        val = leaves[key]
        leaves[key] = ({name: resize_axis(v, 1, dst_len)
                        for name, v in val.items()}
                       if isinstance(val, dict)
                       else resize_axis(val, 1, dst_len))
    s["state"] = T.restore_decode_slot(engine.cfg, s["state"], slot,
                                       leaves, snap.pos)
    req = snap.request
    if kind == "stream":
        s["slot_req"][slot] = req
        s["cursors"][slot] = snap.cursor
        s["epoch"][slot] = dict(engine.placements)
        s["cap"][slot] = snap.cap
    else:
        s["reqs"].append(req)
        s["cursors"].append(snap.cursor)
        s["active"].append(True)
        s["epoch"].append(dict(engine.placements))
        s["cap"].append(snap.cap)
    req.served_by = engine.name
    billed = engine.placements.get("decode") or engine.placements.get(
        "prefill")
    req.destination = billed.destination if billed else None
    engine.active.append(req)
    engine.stats.migrations_in += 1
    engine.stats.migration_ws += snap.nbytes / (1 << 20) * transfer_ws_per_mib
    return slot


def migrate(source: ServingEngine, target: ServingEngine, slot: int, *,
            now: Optional[float] = None,
            transfer_ws_per_mib: float = DEFAULT_TRANSFER_WS_PER_MIB) -> int:
    """The transactional move: snapshot ``slot`` off ``source``, restore it
    into ``target``, and only then detach the source slot — a refusal at
    restore leaves the source exactly as it was. Returns the target slot."""
    if source is target:
        raise MigrationError("source and target are the same engine")
    snap = snapshot_slot(source, slot)
    dst = restore_slot(target, snap, now=now,
                       transfer_ws_per_mib=transfer_ws_per_mib)
    detach_slot(source, slot)
    return dst
