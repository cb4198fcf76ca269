"""The port's ``core/hlo_analysis.py`` against the JAX package's, bit for
bit, on every HLO string of the reference's units
(``tests/test_dryrun_small.py``, from ``test_collective_stats_parses_kinds``
on): ``collective_stats``' fields, ``remat_stats``' dicts and the unknown
dtype's warning; and ``issued_collective_stats``, the port's builder from
the collectives a run issued, against ``collective_stats`` on an HLO line
of the same op."""
import warnings

import pytest

from repro.core import hlo_analysis as ref
from repro_torch.core import hlo_analysis as port

_WHILE_HLO = """
%body.7 (p.1: (s32[], f32[256])) -> (s32[], f32[256]) {
  %p.1 = (s32[], f32[256]) parameter(0)
  %ar.1 = f32[256] all-reduce(%gte.1), replica_groups={{0,1,2,3}}, to_apply=%add
  ROOT %tuple.1 = (s32[], f32[256]) tuple(%next, %ar.1)
}

%cond.9 (p.2: (s32[], f32[256])) -> pred[] {
  %p.2 = (s32[], f32[256]) parameter(0)
  %iv = s32[] get-tuple-element(%p.2), index=0
  %limit = s32[] constant(12)
  ROOT %lt = pred[] compare(%iv, %limit), direction=LT
}

ENTRY %main.20 (arg0: f32[256]) -> f32[256] {
  %ag.0 = f32[512] all-gather(%arg0), replica_groups={{0,1}}, dimensions={0}
  %w = (s32[], f32[256]) while(%init), condition=%cond.9, body=%body.7
  ROOT %out = f32[256] get-tuple-element(%w), index=1
}
"""

_NESTED_HLO = """
%inner_body.1 (p: (s32[], f32[64])) -> (s32[], f32[64]) {
  %ar.i = f32[64] all-reduce(%g), replica_groups={{0,1}}, to_apply=%add
}

%inner_cond.1 (p: (s32[], f32[64])) -> pred[] {
  %k.i = s32[] constant(3)
  ROOT %lt.i = pred[] compare(%iv.i, %k.i), direction=LT
}

%outer_body.1 (p: (s32[], f32[64])) -> (s32[], f32[64]) {
  %w.i = (s32[], f32[64]) while(%t), condition=%inner_cond.1, body=%inner_body.1
}

%outer_cond.1 (p: (s32[], f32[64])) -> pred[] {
  %k.o = s32[] constant(5)
  ROOT %lt.o = pred[] compare(%iv.o, %k.o), direction=LT
}

ENTRY %main.1 (a: f32[64]) -> f32[64] {
  %w.o = (s32[], f32[64]) while(%t0), condition=%outer_cond.1, body=%outer_body.1
}
"""

# (name, HLO text, default_group, the reference unit's expectations:
# count and bytes by kind)
COLLECTIVE_CASES = [
    ("parses_kinds", """
  %ar = f32[128,256] all-reduce(%x), replica_groups=[16,16]<=[256], to_apply=%add
  %ag = bf16[64,512] all-gather(%y), replica_groups={{0,1,2,3}}, dimensions={1}
  %cp = f32[32] collective-permute(%z), source_target_pairs={{0,1}}
    """, 8, 3, {"all-reduce": 2 * 128 * 256 * 4 * 15 / 16,
                "all-gather": 64 * 512 * 2 * 3 / 4,
                "collective-permute": 32 * 4}),
    ("ignores_noncollectives", "%d = f32[8,8] dot(%a, %b)", 1, 0, {}),
    ("while_trip_counts", _WHILE_HLO, 1, 13,
     {"all-reduce": 12 * 2 * 256 * 4 * 3 / 4, "all-gather": 512 * 4 / 2}),
    ("underivable_trip_counts_once", _WHILE_HLO.replace(
        "%limit = s32[] constant(12)",
        "%limit = s32[] get-tuple-element(%p.2), index=1"), 1, 2,
     {"all-reduce": 2 * 256 * 4 * 3 / 4, "all-gather": 512 * 4 / 2}),
    ("nested_while_trips_multiply", _NESTED_HLO, 1, 15,
     {"all-reduce": 15 * 64 * 4}),
    ("iota_groups", "%ar = f32[64] all-reduce(%x), replica_groups=[2,8]<=[16]"
     ", to_apply=%a", 1, 1, {"all-reduce": 2 * 64 * 4 * 7 / 8}),
    ("iota_groups_of_one", "%ar = f32[64] all-reduce(%x), "
     "replica_groups=[16,1]<=[16], to_apply=%a", 1, 0, {}),
    ("iota_groups_transposed", "%ag = bf16[32,32] all-gather(%y), "
     "replica_groups=[4,4]<=[2,8]T(1,0), dimensions={0}", 1, 1,
     {"all-gather": 32 * 32 * 2 * 3 / 4}),
]


@pytest.mark.parametrize("name,hlo,group,count,by_kind", COLLECTIVE_CASES,
                         ids=[c[0] for c in COLLECTIVE_CASES])
def test_collective_stats_match_reference(name, hlo, group, count, by_kind):
    got = port.collective_stats(hlo, default_group=group)
    want = ref.collective_stats(hlo, default_group=group)
    assert (got.wire_bytes, got.by_kind, got.count) == \
        (want.wire_bytes, want.by_kind, want.count)
    assert got.count == count
    assert got.by_kind == pytest.approx(by_kind)


REMAT_CASES = [
    ("duplicate_dots", """
  %dot.1 = f32[128,64] dot(%a, %b)
  %dot.2 = f32[128,64] dot(%a, %b)
  %dot.3 = f32[32,16] dot(%c, %d)
    """, {"dot_signatures": 2, "duplicated_signatures": 1,
          "max_duplication": 2}),
    ("no_dots", _WHILE_HLO, {"dot_signatures": 0, "duplicated_signatures": 0,
                             "max_duplication": 1}),
]


@pytest.mark.parametrize("name,hlo,want", REMAT_CASES,
                         ids=[c[0] for c in REMAT_CASES])
def test_remat_stats_match_reference(name, hlo, want):
    got = port.remat_stats(hlo)
    assert got == ref.remat_stats(hlo) == want


def test_unknown_dtype_warns_as_the_reference():
    hlo = ("%ar = f8e8m0fnu[128] all-reduce(%x), replica_groups={{0,1}}, "
           "to_apply=%a")
    seen = {}
    for name, mod in (("port", port), ("ref", ref)):
        mod._warned_dtypes.discard("f8e8m0fnu")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            stats = mod.collective_stats(hlo)
            again = mod.collective_stats(hlo)  # warned once only
        seen[name] = ([(w.category, str(w.message)) for w in caught],
                      (stats.wire_bytes, stats.by_kind, stats.count),
                      again.wire_bytes)
    assert seen["port"] == seen["ref"]
    assert len(seen["port"][0]) == 1
    assert seen["port"][0][0][0] is UserWarning
    assert "unknown dtype 'f8e8m0fnu'" in seen["port"][0][0][1]
    # bit-width fallback: f8... -> 1 byte/element
    assert seen["port"][1][1]["all-reduce"] == pytest.approx(2 * 128 / 2)


# one HLO line of each kind, its result (f32[48,64]: 12288 bytes) over a
# group of 4
ISSUED_KINDS = {
    "all-reduce": "%ar = f32[48,64] all-reduce(%x), replica_groups="
                  "{{0,1,2,3}}, to_apply=%add",
    "all-gather": "%ag = f32[48,64] all-gather(%x), replica_groups="
                  "{{0,1,2,3}}, dimensions={0}",
    "reduce-scatter": "%rs = f32[48,64] reduce-scatter(%x), replica_groups="
                      "{{0,1,2,3}}, dimensions={0}, to_apply=%add",
    "all-to-all": "%aa = f32[48,64] all-to-all(%x), replica_groups="
                  "{{0,1,2,3}}, dimensions={0}",
    "collective-permute": "%cp = f32[48,64] collective-permute(%x), "
                          "source_target_pairs={{0,1}}",
}


@pytest.mark.parametrize("kind", sorted(ISSUED_KINDS))
def test_issued_collectives_bill_as_an_hlo_line(kind):
    want = port.collective_stats(ISSUED_KINDS[kind], default_group=4)
    got = port.issued_collective_stats([(kind, 48 * 64 * 4, 4)])
    assert (got.wire_bytes, got.by_kind, got.count) == \
        (want.wire_bytes, want.by_kind, want.count)
    assert got.count == 1
    # groups of one device and empty results move nothing, as in the HLO
    none = port.issued_collective_stats([(kind, 48 * 64 * 4, 1),
                                         (kind, 0, 4)])
    assert (none.wire_bytes, none.by_kind, none.count) == (0.0, {}, 0)
    with pytest.raises(ValueError):
        port.wire_bytes("broadcast", 4.0, 2)
