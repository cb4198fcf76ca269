"""The port's mid-flight slot migration against the JAX package's, on the CPU.

The reference's differential harness (``tests/test_migration.py``) runs
through both packages on the same weights: the reduced llama3.2-3b (dense
KV), rwkv6-1.6b (recurrent), zamba2-7b (hybrid, at 5 layers so that it has
a ``mamba_tail``), mixtral-8x7b (MoE with a sliding-window ring) and
seamless-m4t-medium (enc-dec, with ``cross_k``/``cross_v`` among the
cache-length leaves), in float32 as ``tests/test_torch_serving.py`` runs
them, drawn by the reference's ``init_params`` and carried across. Slot 0's
request moves to a roomier engine right after admission, mid-decode or one
token before eos (before its last token under ``max_new_tokens`` where no
eos point exists: the dense model, whose case the reference's harness
skips). The port's migrated tokens and finish reasons must equal
its own never-migrated baseline and the reference's migrated run; the
snapshot's manifest, digest and ``nbytes``, the target's ``migration_ws``
and both engines' ``EngineStats`` must equal the reference's exactly.

Snapshot leaf values are held to the tolerance the model tests hold decode
state to: within 1e-4 of the largest magnitude for float32 leaves, and one
bf16 ulp (2^-7 of the largest) for bfloat16 leaves; an all-zero reference
leaf must be zero. One case is named where manifests differ: a hybrid slot
restored into a never-stepped state, whose ``conv`` leaves are bfloat16 in
the reference (it starts them in bf16 and carries them in the model's dtype
from the first step on) and float32 in the port (``models/ssm.py``).

The refusals, the cap carry, the wave scheduler, the sleep→migrate→drain
power guard, a snapshot→resize→restore roundtrip property and
``resize_axis``'s edges run on the port alone. The router-bound cases of the
reference's file (``FleetRouter.rebalance``, the fleet ledger under the
router, the concurrent run) are in ``tests/test_torch_fleet.py``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro import models as RM
from repro import runtime as RR
from repro.checkpoint.checkpointer import resize_axis as ref_resize_axis
from repro.checkpoint.checkpointer import tree_paths as ref_tree_paths
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro_torch import models as M
from repro_torch import runtime as PR
from repro_torch.checkpoint import resize_axis, tree_paths
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as T
from repro_torch.runtime import migration

FAMILIES = {
    "dense": "llama3.2-3b",
    "ssm": "rwkv6-1.6b",
    "hybrid": "zamba2-7b",
    "moe": "mixtral-8x7b",
    "encdec": "seamless-m4t-medium",
}
DENSE, HYBRID, MOE = "llama3.2-3b", "zamba2-7b", "mixtral-8x7b"
CHANGES = {HYBRID: {"num_layers": 5}}  # two groups and a tail
F32_TOL = 1e-4
BF16_TOL = 2.0 ** -7


@functools.lru_cache(maxsize=None)
def _models(arch):
    changes = dict(CHANGES.get(arch, {}), dtype="float32")
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = M.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    "cpu")
    return {RR: (rcfg, params), PR: (cfg, model)}


def _engine(pkg, arch=DENSE, **kw):
    cfg, weights = _models(arch)[pkg]
    if pkg is PR:
        kw["device"] = "cpu"
    return pkg.ServingEngine(cfg, weights, **kw)


def _requests(pkg, eos=None, rid0_prompt=(2, 5, 9)):
    """The reference harness's request set; rid 1 length-caps (its budget
    exceeds max_len=32), so every run also exercises the cap carry."""
    return [
        pkg.Request(rid=0, prompt=list(rid0_prompt), max_new_tokens=6,
                    eos_id=eos),
        pkg.Request(rid=1, prompt=[3, 7], max_new_tokens=40, eos_id=eos),
        pkg.Request(rid=2, prompt=[4, 1, 6, 8], max_new_tokens=5,
                    eos_id=eos),
        pkg.Request(rid=3, prompt=[5, 2], max_new_tokens=4, eos_id=eos),
    ]


def _record(rs):
    return {r.rid: (tuple(r.output), r.finish_reason) for r in rs}


@functools.lru_cache(maxsize=None)
def _golden(pkg, arch, eos=None, rid0_prompt=(2, 5, 9)):
    """Never-migrated baseline: one engine serves the whole set."""
    eng = _engine(pkg, arch, slots=2, max_len=32)
    rs = _requests(pkg, eos, rid0_prompt)
    for r in rs:
        eng.submit(r)
    eng.run()
    return _record(rs)


def _migrated_run(pkg, arch, eos, trigger, rid0_prompt=(2, 5, 9),
                  dst_max_len=48):
    """The same set, but slot 0's occupant (rid 0) moves to a second engine
    with a roomier cache the moment ``trigger`` fires. Returns the record,
    both engines, the snapshot the move carried and a snapshot of the
    target slot right after the restore."""
    src = _engine(pkg, arch, slots=2, max_len=32, name="src")
    dst = _engine(pkg, arch, slots=2, max_len=dst_max_len, name="dst")
    rs = _requests(pkg, eos, rid0_prompt)
    for r in rs:
        src.submit(r)
    src.stream_open()
    dst.stream_open()
    snap = None
    for _ in range(400):
        if (snap is None and src._stream["slot_req"][0] is rs[0]
                and trigger(rs)):
            snap = src.snapshot_slot(0)  # read-only: what migrate carries
            # and the target slot as the restore left it
            restored = dst.snapshot_slot(pkg.migrate(src, dst, 0))
        f = src.stream_step()
        g = dst.stream_step()
        if f is None and g is None:
            break
    src.stream_close()
    dst.stream_close()
    assert snap is not None, "the forced migration never fired"
    return _record(rs), src, dst, snap, restored


@functools.lru_cache(maxsize=None)
def _eos_point(arch):
    """The reference harness's (rid0 prompt, position, token) to force eos
    on, found by the reference: the first probe prompt whose natural output
    has a late token not seen earlier; None when none has (the reduced
    dense model repeats a prompt's last token, in float32 as in the
    reference's bfloat16, where its own harness skips this case)."""
    for prompt in ((2, 5, 9), (1, 4, 8), (3, 6, 2), (7, 2, 11), (9, 3, 5)):
        eng = _engine(RR, arch, slots=2, max_len=32)
        probe = RR.Request(rid=0, prompt=list(prompt), max_new_tokens=6)
        eng.submit(probe)
        eng.run()
        nat = list(probe.output)
        for i in range(1, len(nat)):
            if nat[i] not in nat[:i]:
                return prompt, i, nat[i]
    return None


def _rel(port_leaf, ref_leaf):
    """max |port - ref| over max |ref|; an all-zero ref must match exactly
    (then 0.0 or inf)."""
    ref = np.asarray(ref_leaf, np.float32)
    diff = float(np.max(np.abs(port_leaf.float().numpy() - ref)))
    scale = float(np.max(np.abs(ref)))
    if scale == 0.0:
        return 0.0 if diff == 0.0 else float("inf")
    return diff / scale


def _assert_leaves_close(port_leaves, ref_leaves, skip=()):
    port = tree_paths(port_leaves)
    ref = ref_tree_paths(ref_leaves)
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, pl), (_, rl) in zip(port, ref):
        if path in skip:
            continue
        assert tuple(pl.shape) == rl.shape, path
        tol = F32_TOL if pl.dtype == torch.float32 else BF16_TOL
        assert _rel(pl, rl) <= tol, path


def _assert_snapshots_match(port, ref):
    """Manifest, digest and bytes exactly; leaf values within the stated
    tolerance; the slot's bookkeeping exactly."""
    assert port.manifest == ref.manifest
    assert port.digest == ref.digest
    assert port.nbytes == ref.nbytes
    assert (port.cursor, port.pos, port.cap, port.source,
            port.source_max_len) == (ref.cursor, ref.pos, ref.cap,
                                     ref.source, ref.source_max_len)
    assert port.request.rid == ref.request.rid
    _assert_leaves_close(port.leaves, ref.leaves)


CONV = {"mamba/conv", "mamba_tail/conv"}


def _assert_restored_match(port, ref):
    """Snapshots of the target slot right after the restore: as
    ``_assert_snapshots_match``, but for the one named difference. The
    hybrid's ``conv`` leaves of a slot restored into a never-stepped state
    are bfloat16 in the reference (which casts into the fresh state's
    dtype) and float32 in the port; their values agree once cast to
    bfloat16, within one bf16 ulp."""
    differ = {p for p in ref.manifest if port.manifest[p] != ref.manifest[p]}
    assert differ <= CONV
    for path in differ:
        assert ref.manifest[path]["dtype"] == "bfloat16"
        assert port.manifest[path] == dict(ref.manifest[path],
                                           dtype="float32")
    assert port.nbytes == ref.nbytes + sum(
        2 * np.prod(ref.manifest[p]["shape"]) for p in differ)
    assert (port.cursor, port.pos, port.cap, port.source,
            port.source_max_len) == (ref.cursor, ref.pos, ref.cap,
                                     ref.source, ref.source_max_len)
    _assert_leaves_close(port.leaves, ref.leaves, skip=differ)
    port_leaves = dict(tree_paths(port.leaves))
    ref_leaves = dict(ref_tree_paths(ref.leaves))
    for path in differ:
        assert _rel(port_leaves[path].to(torch.bfloat16),
                    ref_leaves[path]) <= BF16_TOL, path
    return differ


def _stats(eng):
    return dataclasses.asdict(eng.stats)


def _trigger(arch, point):
    """(eos, rid0 prompt, trigger) of a harness point."""
    if point == "before_eos" and _eos_point(arch) is not None:
        prompt, i, eos = _eos_point(arch)
        return eos, prompt, (lambda rs: len(rs[0].output) == i)
    if point == "before_eos":  # one token before max_new_tokens ends it
        return None, (2, 5, 9), (lambda rs: len(rs[0].output) == 5)
    if point == "admission":
        return None, (2, 5, 9), (lambda rs: True)  # the step after it fills
    return None, (2, 5, 9), (lambda rs: len(rs[0].output) >= 2)


# ---------------------------------------------------------------------------
# Differential harness: migrated == never-migrated == the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("point", ["admission", "mid_decode", "before_eos"])
def test_migrated_traffic_matches_baseline_and_reference(family, point):
    arch = FAMILIES[family]
    eos, prompt, trigger = _trigger(arch, point)
    golden = _golden(PR, arch, eos, prompt)
    assert golden == _golden(RR, arch, eos, prompt)
    got, src, dst, snap, restored = _migrated_run(PR, arch, eos, trigger,
                                                  prompt)
    ref, rsrc, rdst, rsnap, rrestored = _migrated_run(RR, arch, eos,
                                                      trigger, prompt)
    assert got == golden
    assert got == ref
    if eos is None:  # with a forced eos rid 1 may stop before the cap
        assert golden[1][1] == "length_cap"  # the cap-carry witness
    _assert_snapshots_match(snap, rsnap)
    differ = _assert_restored_match(restored, rrestored)
    assert differ == (CONV if family == "hybrid" else set())
    assert restored.pos == snap.pos and restored.cursor == snap.cursor
    assert snap.nbytes > 0
    # both ledgers, the transfer-cost line included, bit for bit
    assert _stats(src) == _stats(rsrc)
    assert _stats(dst) == _stats(rdst)
    assert src.stats.migrations_out == dst.stats.migrations_in == 1
    assert dst.stats.migration_ws == snap.nbytes / (1 << 20) * 0.5
    assert src.stats.migration_ws == 0.0
    # no token billed twice across the two engines
    prompts = sum(len(r.prompt) for r in _requests(PR, eos, prompt))
    assert src.stats.total_tokens + dst.stats.total_tokens \
        == prompts + sum(len(out) - 1 for out, _ in golden.values())


def test_fresh_hybrid_conv_is_the_one_manifest_difference():
    """A hybrid slot restored into a never-stepped state and snapshotted
    again: the reference casts the snapshot's float32 ``conv`` leaves to the
    fresh state's bfloat16, the port keeps float32. Those two leaves are the
    only manifest entries that differ; their values agree once cast to
    bfloat16, within one bf16 ulp. Every other leaf agrees as stated."""
    snaps = {}
    for pkg in (PR, RR):
        src = _engine(pkg, HYBRID, slots=2, max_len=32, name="src")
        dst = _engine(pkg, HYBRID, slots=2, max_len=48, name="dst")
        for r in _requests(pkg)[:2]:
            src.submit(r)
        src.stream_open()
        dst.stream_open()
        for _ in range(3):
            src.stream_step()
        snap = src.snapshot_slot(0)
        snaps[pkg] = snap, dst.snapshot_slot(dst.restore_slot(snap))
    _assert_snapshots_match(snaps[PR][0], snaps[RR][0])
    assert _assert_restored_match(snaps[PR][1], snaps[RR][1]) == CONV


def test_wave_scheduler_migration_token_identical():
    """The wave scheduler migrates too: a mid-wave slot moves into an empty
    wave on a roomier engine and the wave's outputs are unchanged, and equal
    to the reference's."""
    records = {}
    for pkg in (PR, RR):
        base = _engine(pkg, scheduler="wave", slots=2, max_len=32)
        base_rs = _requests(pkg)[:2]
        for r in base_rs:
            base.submit(r)
        base.run()
        src = _engine(pkg, scheduler="wave", slots=2, max_len=32, name="src")
        dst = _engine(pkg, scheduler="wave", slots=2, max_len=48, name="dst")
        rs = _requests(pkg)[:2]
        src.wave_open(rs)
        dst.wave_open([])
        for _ in range(4):
            src.wave_step()
        pkg.migrate(src, dst, 0)
        for _ in range(200):
            f = src.wave_step()
            g = dst.wave_step()
            if f is None and g is None:
                break
        src.wave_close()
        dst.wave_close()
        assert _record(rs) == _record(base_rs)
        assert src.stats.migrations_out == dst.stats.migrations_in == 1
        records[pkg] = _record(rs), _stats(src), _stats(dst)
    assert records[PR] == records[RR]


def test_cap_carries_through_to_a_roomier_destination():
    """A request admitted under max_len=16 keeps capping at 16 after moving
    to a 48-row engine, as its never-migrated baseline does."""
    base = _engine(PR, slots=1, max_len=16)
    b = PR.Request(rid=0, prompt=[2, 5], max_new_tokens=64)
    base.submit(b)
    base.run()
    assert b.finish_reason == "length_cap"
    src = _engine(PR, slots=1, max_len=16, name="src")
    dst = _engine(PR, slots=1, max_len=48, name="dst")
    r = PR.Request(rid=0, prompt=[2, 5], max_new_tokens=64)
    src.submit(r)
    src.stream_open()
    dst.stream_open()
    for _ in range(5):
        src.stream_step()
    PR.migrate(src, dst, 0)
    assert dst._stream["cap"][0] == 16
    for _ in range(200):
        f = src.stream_step()
        g = dst.stream_step()
        if f is None and g is None:
            break
    src.stream_close()
    dst.stream_close()
    assert (tuple(r.output), r.finish_reason) \
        == (tuple(b.output), b.finish_reason)


def test_transfer_cost_bills_by_bytes_on_the_target():
    src, _ = _src_with_work()
    dst = _engine(PR, slots=2, max_len=32, name="dst")
    dst.stream_open()
    snap = src.snapshot_slot(0)
    dst.restore_slot(snap, transfer_ws_per_mib=2.0)
    migration.detach_slot(src, 0)
    assert dst.stats.migration_ws == pytest.approx(
        snap.nbytes / (1 << 20) * 2.0)
    assert src.stats.migration_ws == 0.0
    assert dst.stats.total_ws == pytest.approx(
        dst.stats.energy_ws + dst.stats.idle_ws + dst.stats.migration_ws)


# ---------------------------------------------------------------------------
# Power guard: sleep -> migrate -> drain
# ---------------------------------------------------------------------------


def test_sleep_migrate_drain_wake_charges_then_refuses_deterministically():
    """No clock: refusal with nothing consumed. With a clock: the wake is
    charged once and the restore refuses until its latency elapses; then
    the move lands and the drain gives the never-migrated tokens."""
    src = _engine(PR, slots=2, max_len=32, name="src")
    dst = _engine(PR, slots=2, max_len=32, name="dst")
    dst.set_power(idle_watts=10.0, wake_s=2.0)
    rs = _requests(PR)
    for r in rs:
        src.submit(r)
    src.stream_open()
    dst.stream_open()
    dst.sleep()
    for _ in range(4):
        src.stream_step()
    before = _source_image(src)
    with pytest.raises(PR.MigrationError, match="no clock"):
        PR.migrate(src, dst, 0)
    _assert_source_unchanged(src, before)
    assert dst.power_state == "asleep"
    assert dst.stats.wakes == 0 and dst.stats.migrations_in == 0
    with pytest.raises(PR.MigrationError, match="waking"):
        PR.migrate(src, dst, 0, now=10.0)
    assert dst.power_state == "waking" and dst.stats.wakes == 1
    _assert_source_unchanged(src, before)
    with pytest.raises(PR.MigrationError, match="waking"):
        PR.migrate(src, dst, 0, now=11.0)
    assert dst.stats.wakes == 1  # the retry does not re-charge the wake
    PR.migrate(src, dst, 0, now=12.0)
    assert dst.power_state == "awake"
    assert dst.stats.migrations_in == 1 and src.stats.migrations_out == 1
    for _ in range(400):
        f = src.stream_step()
        g = dst.stream_step()
        if f is None and g is None:
            break
    src.stream_close()
    dst.stream_close()
    assert _record(rs) == _golden(PR, DENSE) == _golden(RR, DENSE)


# ---------------------------------------------------------------------------
# Deterministic refusals: MigrationError, the source left as it was
# ---------------------------------------------------------------------------


def _src_with_work(arch=DENSE, max_len=32, steps=3):
    src = _engine(PR, arch, slots=2, max_len=max_len, name="src")
    rs = _requests(PR)
    for r in rs:
        src.submit(r)
    src.stream_open()
    for _ in range(steps):
        src.stream_step()
    return src, rs


def _source_image(eng):
    s = eng._stream
    state = {path: leaf.clone() for path, leaf in tree_paths(s["state"])}
    return (state, list(s["slot_req"]), list(s["cursors"]), list(s["cap"]),
            list(eng.active), _stats(eng))


def _assert_source_unchanged(eng, before):
    state, *rest = _source_image(eng)
    assert rest == list(before[1:])
    assert state.keys() == before[0].keys()
    for path, leaf in state.items():
        assert torch.equal(leaf, before[0][path]), path


def _refuse_self(src):
    PR.migrate(src, src, 0)


def _refuse_no_free_slot(src):
    dst = _engine(PR, slots=1, max_len=32, name="dst")
    dst.submit(PR.Request(rid=99, prompt=[6, 6], max_new_tokens=30))
    dst.stream_open()
    dst.stream_step()  # the only slot fills
    PR.migrate(src, dst, 0)


def _refuse_too_short(src):
    # rid 0 can still address min(cap=32, 3+6)=9 rows > the 8 offered
    dst = _engine(PR, slots=2, max_len=8, name="dst")
    dst.stream_open()
    PR.migrate(src, dst, 0)


def _refuse_tampered_digest(src):
    dst = _engine(PR, slots=2, max_len=32, name="dst")
    dst.stream_open()
    snap = src.snapshot_slot(0)
    path = next(iter(snap.manifest))
    snap.manifest[path] = dict(snap.manifest[path], dtype="tampered")
    try:
        dst.restore_slot(snap)
    finally:
        assert dst.stats.migrations_in == 0
        assert dst._stream["slot_req"] == [None, None]


def _refuse_asleep_without_clock(src):
    dst = _engine(PR, slots=2, max_len=32, name="dst")
    dst.stream_open()
    dst.sleep()
    PR.migrate(src, dst, 0)


def _refuse_no_target_session(src):
    PR.migrate(src, _engine(PR, slots=2, max_len=32, name="dst"), 0)


REFUSALS = {
    "to_self": (_refuse_self, "same engine"),
    "no_free_slot": (_refuse_no_free_slot, "no free slot"),
    "target_too_short": (_refuse_too_short, "cannot hold"),
    "tampered_digest": (_refuse_tampered_digest, "digest"),
    "asleep_without_clock": (_refuse_asleep_without_clock, "no clock"),
    "no_target_session": (_refuse_no_target_session, "no open session"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusal_leaves_the_source_untouched(case):
    fn, match = REFUSALS[case]
    src, rs = _src_with_work()
    before = _source_image(src)
    with pytest.raises(PR.MigrationError, match=match):
        fn(src)
    _assert_source_unchanged(src, before)
    # transactional: the refused source serves on to the baseline's tokens
    while src.stream_step() is not None:
        pass
    src.stream_close()
    assert _record(rs) == _golden(PR, DENSE)


def test_snapshot_of_free_or_out_of_range_slot_refused():
    eng = _engine(PR, slots=2, max_len=32)
    eng.stream_open()
    before = _source_image(eng)
    for slot in (0, 5, -1):  # nothing admitted; out of range
        with pytest.raises(PR.MigrationError, match="holds no admitted"):
            eng.snapshot_slot(slot)
    _assert_source_unchanged(eng, before)
    eng.stream_close()
    with pytest.raises(PR.MigrationError, match="no open session"):
        eng.snapshot_slot(0)
    eng = _engine(PR, slots=2, max_len=32)
    eng.submit(PR.Request(rid=0, prompt=[2, 5], max_new_tokens=4))
    eng.stream_open()
    eng.stream_step()
    with pytest.raises(PR.MigrationError, match="is free"):
        migration.detach_slot(eng, 1)


def test_sliding_window_ring_length_mismatch_refused():
    """MoE's sliding-window KV ring: ring phase is a function of ring
    length, so differing ring lengths refuse instead of rephasing."""
    cfg, _ = _models(MOE)[PR]
    assert cfg.sliding_window  # reduced() keeps a 32-token window
    src = _engine(PR, MOE, slots=2, max_len=16, name="src")
    dst = _engine(PR, MOE, slots=2, max_len=24, name="dst")
    r = PR.Request(rid=0, prompt=[2, 5], max_new_tokens=3)
    src.submit(r)
    src.stream_open()
    dst.stream_open()
    src.stream_step()
    before = _source_image(src)
    with pytest.raises(PR.MigrationError, match="sliding-window"):
        PR.migrate(src, dst, 0)
    _assert_source_unchanged(src, before)
    assert dst.stats.migrations_in == 0


# ---------------------------------------------------------------------------
# Property: snapshot -> resize -> restore roundtrip identity
# ---------------------------------------------------------------------------


@given(st.sampled_from(["llama3.2-3b", "rwkv6-1.6b", "seamless-m4t-medium"]),
       st.sampled_from([24, 32, 48]),
       st.integers(0, 4))
@settings(max_examples=8, deadline=None)
def test_snapshot_restore_roundtrip_identity(arch, dst_len, steps):
    """Restoring a snapshot and snapshotting it again returns the same
    request state: metadata exactly, leaves exactly over the rows both
    caches hold (padding past the source length is zeros), the other slot
    of the target untouched."""
    src = _engine(PR, arch, slots=2, max_len=32, name="src")
    dst = _engine(PR, arch, slots=2, max_len=dst_len, name="dst")
    for i in range(2):
        src.submit(PR.Request(rid=i, prompt=[2 + i, 5, 9], max_new_tokens=4))
        dst.submit(PR.Request(rid=10 + i, prompt=[3 + i, 1],
                              max_new_tokens=1 + 6 * i))
    src.stream_open()
    dst.stream_open()
    for _ in range(steps + 1):  # >= 1 step so slot 0 is occupied
        src.stream_step()
    for _ in range(3):  # rid 10 finishes, rid 11 decodes on in slot 1
        dst.stream_step()
    assert dst._stream["slot_req"][0] is None
    other = {p: v[:, 1].clone() for p, v in tree_paths(dst._stream["state"])
             if p != "pos"}
    snap = src.snapshot_slot(0)
    slot = dst.restore_slot(snap)
    assert slot == 0
    resnap = dst.snapshot_slot(slot)
    assert resnap.request is snap.request
    assert (resnap.cursor, resnap.pos) == (snap.cursor, snap.pos)
    assert resnap.cap == snap.cap == 32  # the admitting engine's max_len
    cache_keys = T.decode_state_cache_keys(_models(arch)[PR][0])
    for key in snap.leaves:
        a, b = tree_paths(snap.leaves[key]), tree_paths(resnap.leaves[key])
        for (_, la), (_, lb) in zip(a, b):
            if key in cache_keys:
                n = min(la.shape[1], lb.shape[1])
                assert not lb[:, n:].any()
                la, lb = la[:, :n], lb[:, :n]
            assert torch.equal(la, lb), key
    for p, v in tree_paths(dst._stream["state"]):
        if p != "pos":
            assert torch.equal(v[:, 1], other[p]), p
    src.stream_close()
    dst.stream_close()


def test_extract_is_a_copy_not_a_view():
    """The engine updates its state in place: a snapshot taken before more
    steps keeps the values it was taken with."""
    src, _ = _src_with_work()
    snap = src.snapshot_slot(0)
    kept = {p: v.clone() for p, v in tree_paths(snap.leaves)}
    for _ in range(3):
        src.stream_step()
    assert any(not torch.equal(v[:, 0], kept[p])
               for p, v in tree_paths(src._stream["state"]) if p != "pos")
    for p, v in tree_paths(snap.leaves):
        assert torch.equal(v, kept[p]), p
        assert v.device.type == "cpu" and v.is_contiguous()


@pytest.mark.parametrize("new_len", [0, 2, 4, 6])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_resize_axis_matches_the_reference(axis, new_len):
    """Identity returns the tensor itself; growth zero-pads the tail;
    truncation keeps the head; all as the reference's numpy version."""
    arr = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)
    t = torch.from_numpy(arr.copy())
    got = resize_axis(t, axis, new_len)
    np.testing.assert_array_equal(got.numpy(),
                                  ref_resize_axis(arr, axis, new_len))
    if new_len == arr.shape[axis]:
        assert got is t


def test_resize_axis_roundtrip_edges_bf16():
    t = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3).to(
        torch.bfloat16)
    grown = resize_axis(t, 1, 6)
    assert grown.shape == (2, 6, 3) and grown.dtype == torch.bfloat16
    assert torch.equal(grown[:, :4], t) and not grown[:, 4:].any()
    assert torch.equal(resize_axis(grown, 1, 4), t)


def test_tree_paths_and_digest_match_the_reference():
    from repro.checkpoint.checkpointer import _digest as ref_digest
    from repro_torch.checkpoint.checkpointer import _digest
    tree = {"b": {"y": np.zeros((2, 3), np.float32), "x": np.ones(4)},
            "a": [np.zeros(1), {"c": np.zeros(2)}]}
    ref = ref_tree_paths(tree)
    port = tree_paths(tree)
    assert [p for p, _ in port] == [p for p, _ in ref]
    assert all(a is b for (_, a), (_, b) in zip(port, ref))
    manifest = {p: {"shape": list(v.shape), "dtype": str(v.dtype)}
                for p, v in ref}
    assert _digest(manifest) == ref_digest(manifest)
