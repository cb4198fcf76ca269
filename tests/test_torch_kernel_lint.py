"""The port's kernel lint (``repro_torch.analysis.kernel_lint``) on the CPU.

The four kernel families' launches, captured through their real wrappers
on fake CUDA tensors (the wrappers check them and launch nothing), lint
clean with the launch counts the code makes; a synthetic launch fires each
rule; the reference's ``lint_captured`` and the port's give the same rules
on the same geometry (the cases of ``tests/test_analysis.py`` translated
from BlockSpecs into tiles, the reference's rule names mapped to the
port's); and each kernel module's ``launch_plan`` matches the host code of
the ``.cu`` it mirrors: its constants read from the source, and its grid,
block and shared memory at the shapes of PERF.md §6 against the numbers
that host code gives (the card holds the two equal through each library's
``<prefix>_plan``: ``tests/test_torch_analysis_card.py``).
"""
import functools
import re
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import kernel_lint
from repro_torch.analysis.kernel_lint import (KERNEL_FAMILIES,
                                              capture_family,
                                              capture_launches,
                                              lint_captured,
                                              lint_kernel_families)
from repro_torch.kernels._build import CapturedLaunch, Tile
from repro_torch.kernels.flash_attention import kernel as b3
from repro_torch.kernels.himeno import kernel as b1
from repro_torch.kernels.rmsnorm import kernel as b2
from repro_torch.kernels.wkv import kernel as b4

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
F32 = torch.float32


def test_repo_kernels_lint_clean():
    findings, counts = lint_kernel_families()
    assert findings == []
    # flash: the tensor-core forward, its backward's three, the scalar
    # forward, its backward's three; wkv: the chunked forward, the carry
    # and chunks' kernels, the sequential forward and backward; rmsnorm:
    # two forwards, the gradient's two; himeno: one sweep
    assert counts == {"flash_attention": 8, "wkv": 5, "rmsnorm": 4,
                      "himeno": 1}


@pytest.mark.parametrize("family", sorted(KERNEL_FAMILIES))
def test_fake_tensors_on_either_device_plan_alike(family, monkeypatch):
    """The wrappers' fake branch records the same launches for fake tensors
    on the CPU (the dry run's) and on the card."""
    def geometry():
        return [(c.kernel_name, c.grid, c.block, c.smem, c.plan_args)
                for c in capture_family(KERNEL_FAMILIES[family])]

    on_card = geometry()
    monkeypatch.setattr(kernel_lint, "_fake",
                        functools.partial(kernel_lint._fake, device="cpu"))
    assert geometry() == on_card


def test_real_cpu_tensors_record_nothing():
    """Real tensors never take the fake branch: on the CPU the wrappers run
    their plain versions and record no launch."""
    x = torch.randn(4, 64)
    with capture_launches() as captured:
        y = b2.rms_norm_cuda(x, torch.ones(64))
    assert captured == []
    assert torch.allclose(y, b2.rms_norm_ref(x, torch.ones(64)))


# ---------------------------------------------------------------------------
# Synthetic launches: each rule fires
# ---------------------------------------------------------------------------


def _launch(in_index=lambda x, y, z: (x, 0), out_index=lambda x, y, z: (x, 0),
            grid=(4, 1, 1), block=(128, 1, 1), smem=0, opt_in=False,
            bounds=256, rows=16, alias=None, alias_shape=None):
    ops = [Tile("in0", (rows, 8), F32, (4, 8), in_index),
           Tile("out0", alias_shape or (rows, 8), F32, (4, 8), out_index,
                written=True, alias=alias)]
    return CapturedLaunch("<lambda>", grid, block, smem, opt_in, bounds, ops)


_RULES = {
    "off-by-one tile map": (dict(in_index=lambda x, y, z: (x + 1, 0)),
                            [("oob-block", "error", "t/<lambda>/in0")]),
    "floor-divided grid": (dict(rows=18, grid=(18 // 4, 1, 1)),
                           [("uncovered-output", "error",
                             "t/<lambda>/out0")]),
    "grid of 0": (dict(grid=(0, 1, 1)), [("empty-grid", "error",
                                          "t/<lambda>")]),
    "grid y over 65,535": (dict(grid=(1, 65536, 1)),
                           [("empty-grid", "error", "t/<lambda>")]),
    "1,025 threads": (dict(block=(1025, 1, 1), bounds=2048),
                      [("block-shape", "error", "t/<lambda>")]),
    "over its launch bounds": (dict(block=(32, 16, 1)),
                               [("block-shape", "error", "t/<lambda>")]),
    "64 KB without opt-in": (dict(smem=64 * 1024),
                             [("smem-opt-in", "warn", "t/<lambda>")]),
    "64 KB with opt-in": (dict(smem=64 * 1024, opt_in=True), []),
    "240,000 bytes": (dict(smem=240_000, opt_in=True),
                      [("smem-overflow", "warn", "t/<lambda>")]),
    "written in place": (
        dict(alias="in0"),
        [("ref-alias", "info", "t/<lambda>/alias:in0->out0")]),
    "in place, other shape": (
        dict(alias="in0", alias_shape=(16, 4)),
        [("ref-alias", "error", "t/<lambda>/alias:in0->out0")]),
}


@pytest.mark.parametrize("case", sorted(_RULES))
def test_synthetic_launch_fires_its_rule(case):
    kwargs, want = _RULES[case]
    findings = lint_captured(_launch(**kwargs), site="t")
    assert [(f.rule, f.severity, f.site) for f in findings] == want


# ---------------------------------------------------------------------------
# Parity with the reference's lint on the same geometry
# ---------------------------------------------------------------------------

# the reference's rule -> the port's
_RULE = {"index-arity": "block-shape",
         "unspecified-memory-space": "smem-opt-in",
         "vmem-overflow": "smem-overflow"}


def _reference_findings(index_map, out_index_map, grid=(4,), scratch=None):
    """``tests/test_analysis.py``'s ``_bad_pallas_call``: a synthetic
    ``pallas_call`` captured and linted by the reference."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from repro.analysis.kernel_lint import capture_pallas_calls
    from repro.analysis.kernel_lint import lint_captured as ref_lint

    x = jnp.zeros((16, 8), jnp.float32)
    with capture_pallas_calls() as captured:
        pl.pallas_call(
            lambda x_ref, o_ref: None,
            grid=grid,
            in_specs=[pl.BlockSpec((4, 8), index_map)],
            out_specs=pl.BlockSpec((4, 8), out_index_map),
            out_shape=jax.ShapeDtypeStruct((16, 8), jnp.float32),
            scratch_shapes=scratch or [],
        )(x)
    (call,) = captured
    return ref_lint(call, site="t")


def _scratch():
    import jax
    import jax.numpy as jnp

    return [jax.ShapeDtypeStruct((8, 8), jnp.float32)]


# each case of tests/test_analysis.py: the reference's geometry, and the
# port's launch of the same geometry (an index map of two arguments on a
# 1-D grid has no CUDA form: its counterpart is a block its kernel cannot
# take; scratch without a memory space is dynamic shared memory without
# the opt-in)
_PARITY = {
    "oob_block": (lambda: _reference_findings(lambda i: (i + 1, 0),
                                              lambda i: (i, 0)),
                  dict(in_index=lambda x, y, z: (x + 1, 0))),
    "uncovered_output": (lambda: _reference_findings(lambda i: (i, 0),
                                                     lambda i: (0, 0)),
                         dict(out_index=lambda x, y, z: (0, 0))),
    "index_arity": (lambda: _reference_findings(lambda i, j: (i, 0),
                                                lambda i: (i, 0)),
                    dict(block=(512, 1, 1))),
    "unannotated_scratch": (lambda: _reference_findings(
        lambda i: (i, 0), lambda i: (i, 0), scratch=_scratch()),
        dict(smem=64 * 1024)),
    "empty_grid": (lambda: _reference_findings(
        lambda i: (i, 0), lambda i: (i, 0), grid=(0,)),
        dict(grid=(0, 1, 1))),
}


@pytest.mark.parametrize("case", sorted(_PARITY))
def test_rules_match_the_reference(case):
    ref_case, port_kwargs = _PARITY[case]
    want = [(_RULE.get(f.rule, f.rule), f.severity) for f in ref_case()]
    got = [(f.rule, f.severity)
           for f in lint_captured(_launch(**port_kwargs), site="t")]
    assert got == want and want


# ---------------------------------------------------------------------------
# The Python plans against the .cu host code
# ---------------------------------------------------------------------------


def _constants(source: str) -> dict:
    """``constexpr int NAME = value;`` of a source, by name (the last one
    where namespaces repeat a name: callers name the one they mean by
    its value's expression)."""
    text = (CSRC / source).read_text()
    return {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (\w+) = ([^;]+);", text)}


def test_constants_match_the_sources():
    h = _constants("himeno.cu")
    assert (int(h["TK"]), int(h["TJ"]), int(h["ICHUNK"])) == (
        b1.TK, b1.TJ, b1.ICHUNK)
    r = (CSRC / "rmsnorm.cu").read_text()
    assert re.search(r"constexpr int BLOCK = (\d+);", r).group(1) \
        == str(b2.BLOCK)
    assert re.search(r"constexpr int DS_COLS = (\d+), DS_GROUPS = (\d+);",
                     r).groups() == (str(b2.DS_COLS), str(b2.DS_GROUPS))
    f = (CSRC / "flash_attention.cu").read_text()
    for name, value in (("BQ", (b3.SCALAR_ROWS, b3.TC_ROWS)),
                        ("THREADS", (b3.SCALAR_THREADS,))):
        found = re.findall(r"constexpr int %s = ([^;]+);" % name, f)
        assert found[0] == str(value[0])
    assert "constexpr int STAGES = %d;" % b3.TC_STAGES in f
    assert "constexpr int BOX = 128 * 128;" in f and b3.BOX == 128 * 128
    assert "constexpr int CONSUMERS = 2;" in f and b3.TC_THREADS == 128 * 3
    assert "constexpr int BWD_THREADS = %d;" % b3.BWD_THREADS in f
    assert "constexpr int SMALL_ROWS = %d;" % b3.BWD_SMALL_ROWS in f
    assert "constexpr int PSTR = BK + 4;" in f and b3.PSTR == 64 + 4
    w = (CSRC / "wkv.cu").read_text()
    # wkv_forward's and wkv_backward's instances, by head dim
    for d, (split, cols) in b4.SEQ.items():
        t = 64 if d == 16 else 32
        assert "launch<%d, %d, %d, %d>(*a, s)" % (d, split, cols, t) in w
    for d, (nr, warps) in b4.BACK.items():
        assert "back::launch<%d, %d, %d>(*a, s)" % (d, nr, warps) in w
    assert "constexpr int NJ = %d;" % b4.NJ in w
    assert "constexpr int C = 64;" in w and b4.CHUNK == 64
    assert "constexpr int T = %d;  // tokens a segment" % b4.SEGMENT in w


def _plans(run):
    return [(c.kernel_name, c.grid, c.block, c.smem)
            for c in capture_family(run)]


def _z(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="cuda")


BF16 = torch.bfloat16

# PERF.md §6's shapes; each plan as the .cu's host code computes it
# (grid, block, dynamic shared memory: the structs' sizes and the
# launchers' formulas worked by hand)
_SHAPES = {
    "himeno L": (lambda: b1.himeno_sweep(
        _z(512, 256, 256), _z(4, 512, 256, 256), _z(3, 512, 256, 256),
        _z(3, 512, 256, 256), _z(512, 256, 256), _z(512, 256, 256)),
        [("himeno_kernel", (8, 32, 16), (32, 8, 1), 0)]),
    "rmsnorm prefill": (lambda: b2.rms_norm_cuda(_z(2, 2048, 3072, dtype=BF16),
                                                 _z(3072)),
                        [("rmsnorm_forward", (4096, 1, 1), (256, 1, 1), 0)]),
    "rmsnorm decode": (lambda: b2.rms_norm_cuda(_z(8, 1, 3072, dtype=BF16),
                                                _z(3072)),
                       [("rmsnorm_forward", (8, 1, 1), (256, 1, 1), 0)]),
    "rmsnorm gradient": (lambda: b2.rms_norm_backward_cuda(
        _z(2, 2048, 3072, dtype=BF16), _z(3072),
        _z(2, 2048, 3072, dtype=BF16)),
        [("rmsnorm_backward", (1056, 1, 1), (256, 1, 1), 0),
         ("rmsnorm_dscale", (96, 1, 1), (256, 1, 1), 0)]),
    "flash tensor cores": (lambda: b3.flash_attention_cuda(
        _z(2, 24, 2048, 128, dtype=BF16), _z(2, 8, 2048, 128, dtype=BF16),
        _z(2, 8, 2048, 128, dtype=BF16)),
        [("flash_fwd_tc", (48, 16, 1), (384, 1, 1), 230400)]),
    "flash tensor cores, D 64": (lambda: b3.flash_attention_cuda(
        _z(2, 16, 2048, 64, dtype=BF16), _z(2, 16, 2048, 64, dtype=BF16),
        _z(2, 16, 2048, 64, dtype=BF16), causal=False),
        [("flash_fwd_tc", (32, 16, 1), (384, 1, 1), 115712)]),
    "flash scalar": (lambda: b3.flash_attention_cuda(
        _z(2, 24, 2048, 128), _z(2, 8, 2048, 128), _z(2, 8, 2048, 128)),
        [("flash_fwd_kernel", (32, 48, 1), (256, 1, 1), 84992)]),
    "flash offset": (lambda: b3.flash_attention_cuda(
        _z(2, 24, 2048, 128, dtype=BF16), _z(2, 8, 32768, 128, dtype=BF16),
        _z(2, 8, 32768, 128, dtype=BF16), q_offset=7 * 2048),
        [("flash_fwd_tc", (48, 16, 1), (384, 1, 1), 230400)]),
    "flash backward, tensor cores": (lambda: b3.flash_attention_backward_cuda(
        *[_z(2, h, 2048, 128, dtype=BF16) for h in (24, 8, 8, 24)],
        _z(2, 24, 2048), _z(2, 24, 2048, 128, dtype=BF16)),
        [("flash_bwd_prep", (12288, 1, 1), (256, 1, 1), 0),
         ("flash_bwd_dkdv_tc", (16, 16, 1), (256, 1, 1), 166400),
         ("flash_bwd_dq_tc", (48, 16, 1), (256, 1, 1), 166400)]),
    "flash backward, scalar": (lambda: b3.flash_attention_backward_cuda(
        *[_z(2, h, 2048, 128) for h in (24, 8, 8, 24)], _z(2, 24, 2048),
        _z(2, 24, 2048, 128)),
        [("flash_bwd_prep", (12288, 1, 1), (256, 1, 1), 0),
         ("flash_bwd_dkdv_kernel", (32, 16, 1), (256, 1, 1), 170496),
         ("flash_bwd_dq_kernel", (32, 48, 1), (256, 1, 1), 153088)]),
    "wkv chunked": (lambda: b4.wkv_cuda(
        *[_z(2, 32, 2048, 64)] * 4, _z(32, 64)),
        [("wkv_chunk_kernel", (2, 64, 1), (256, 1, 1), 169360)]),
    "wkv sequential": (lambda: b4.wkv_cuda(
        *[_z(8, 32, 1, 64)] * 4, _z(32, 64), _z(8, 32, 64, 64)),
        [("wkv_kernel", (4, 256, 1), (128, 1, 1), 0)]),
    "wkv backward, chunked": (lambda: b4.wkv_backward_cuda(
        *[_z(2, 32, 2048, 64)] * 4, _z(32, 64), _z(2, 32, 2048, 64)),
        [("wkv_carry_kernel", (64, 2, 1), (256, 1, 1), 158080),
         ("wkv_chunk_backward_kernel", (32, 64, 1), (256, 1, 1), 207744)]),
    "wkv backward, sequential": (lambda: b4.wkv_backward_cuda(
        *[_z(2, 32, 40, 64)] * 4, _z(32, 64), _z(2, 32, 40, 64)),
        [("wkv_backward_kernel", (2, 64, 1), (256, 1, 1), 184448)]),
}


@pytest.mark.parametrize("case", sorted(_SHAPES))
def test_plans_match_the_host_code(case):
    """The gradient's persistent grid here is the H100's 132 SMs times the
    blocks of 256 threads an SM holds (8): no card to ask."""
    run, want = _SHAPES[case]
    assert _plans(run) == want
    for call in capture_family(run):  # clean but the state B4 writes in place
        assert {(f.rule, f.severity)
                for f in lint_captured(call, site="t")} <= {("ref-alias",
                                                             "info")}


def test_wkv_state_in_place_is_an_alias():
    """B4's decode launch writes the state it is given in place: a
    ``ref-alias`` info finding, shapes and dtypes equal."""
    (call,) = capture_family(lambda: b4.wkv_cuda(
        *[_z(2, 4, 1, 16)] * 4, _z(4, 16), _z(2, 4, 16, 16)))
    assert [(f.rule, f.severity) for f in lint_captured(call, site="t")] \
        == [("ref-alias", "info")]
