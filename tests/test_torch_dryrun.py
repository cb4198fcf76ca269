"""The port's dry run (``repro_torch.launch.dryrun``): a cell's step run
once on fake tensors as one rank of a fake world, its flops, bytes,
collectives and memory read off the run.

The fake worlds start in subprocesses (``tests/_torch_dryrun_world.py``,
all started together), so that a fake default process group never meets a
test worker's: the five cells of the reference's
``tests/test_dryrun_small.py`` at every rank of a fake (4, 2) world
against the ported ``step_flops`` and against one device's run; the delta
method's totals (``probe_costs``) against the full run; and the production
meshes. In this process: each kernel's count under a dry run against its
``cost``, and the refusals (``lower()`` outside a fake world, a fake
tensor at a kernel wrapper outside a dry run). The dry run's collectives
against the gloo world's, rank by rank, are held in
``tests/test_torch_mesh_train.py``'s world test."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_dryrun_world import INNER, PROBED, SMALL

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240
# the world sums' jobs: the (4, 2) world's ranks, two a process
RANK_JOBS = ("0,1", "2,3", "4,5", "6,7")
# the world's flops against the analytic ``step_flops`` (core/
# arithmetic_intensity.py), which prices a train step as 4 forwards
# under remat full (the head and loss, outside remat, run 3), adds the
# optimizer's elementwise flops (10 a parameter, which FlopCounterMode
# does not count), charges the norms' flops (elementwise here) and
# the RWKV and Mamba2 blocks by a closed form: the five cells read 0.89 to
# 1.11 of it
STEP_FLOPS_RTOL = 0.15


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    jobs = {f"sums{r}": ("sums", r) for r in RANK_JOBS}
    jobs.update(probes=("probes", ""), production=("production", ""))
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dryrun_world.py"),
         job, str(tmp / f"{name}.json"), arg],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name, (job, arg) in jobs.items()}
    out = {}
    try:
        for name, p in procs.items():
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, (name, err[-4000:])
            out[name] = json.loads((tmp / f"{name}.json").read_text())
    finally:
        for p in procs.values():
            p.kill()
    return out


def _ok(rec, what):
    assert rec["status"] == "ok", (what, rec.get("error"),
                                   rec.get("traceback"))
    return rec


def test_small_cells_on_a_4x2_world(worlds):
    """(a) Every cell at every rank comes back ``ok`` with no plain kernel
    version run (they raise in the job); the world's flops lie within
    STEP_FLOPS_RTOL of ``step_flops`` and at or above one device's run of
    the same cell (a 1×1 fake world): the excess is the work every model
    rank repeats, none for llama, whose matmuls all split; the train cells
    communicate."""
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.core.arithmetic_intensity import step_flops

    ranks = {}
    for r in RANK_JOBS:
        for cell, by_rank in worlds[f"sums{r}"]["cells"].items():
            ranks.setdefault(cell, {}).update(by_rank)
    one = worlds[f"sums{RANK_JOBS[0]}"]["one_device"]
    assert sorted(ranks) == sorted(f"{a}/{c[1]}" for a, c in SMALL)
    for arch, cell in SMALL:
        key = f"{arch}/{cell[1]}"
        recs = [_ok(ranks[key][str(r)], (key, r)) for r in range(8)]
        shape = ShapeSpec(*cell)
        cfg = reduced(get_config(arch))
        cfg = type(cfg)(**{**cfg.__dict__,
                           "accum": 2 if shape.kind == "train" else 1})
        world = sum(rec["flops"] for rec in recs)
        want = step_flops(cfg, shape, cfg.remat)
        assert abs(world / want - 1) <= STEP_FLOPS_RTOL, (key, world, want)
        single = _ok(one[key], (key, "1x1"))
        assert world >= single["flops"] > 0, (key, world, single["flops"])
        if arch == "llama3.2-3b":
            assert world == single["flops"], (key, world, single["flops"])
        assert single["collectives"]["count"] == 0, key
        if shape.kind == "train":
            for rec in recs:
                assert rec["collectives"]["count"] > 0, key
                assert rec["collectives"]["wire_bytes"] > 0, key
                assert rec["kernels"]["flash_attention_backward"][
                    "launches"] > 0, key


@pytest.mark.parametrize("name", [p[0] for p in PROBED])
def test_probe_costs_equal_the_full_run(worlds, name):
    """(b) The delta method's totals equal a full-depth, full-accumulation
    run of the same cell exactly, in flops and in collective wire bytes
    (and by kind): the accumulation split (llama at accum 4 and 8, from
    probes at 2 and 4), a hybrid's groups and tail (zamba2), enc-dec's two
    deltas (seamless)."""
    rec = _ok(worlds["probes"][name], name)
    full, probe = rec["full"], rec["probe"]["total_per_device"]
    assert probe["flops"] == full["flops"] > 0, (name, probe, full)
    assert probe["collective_bytes"] == full["collectives"]["wire_bytes"] \
        > 0, (name, probe, full)
    assert probe["collective_by_kind"] == full["collectives"]["by_kind"], \
        (name, probe, full)
    if name.startswith("llama"):  # the split extrapolates from 2 and 4
        assert rec["probe"]["probe_accums"] == [2, 4]


def test_production_meshes(worlds):
    """(e) llama3.2-3b ``prefill_32k`` on the 16×16 world under
    ``rules_for``'s layout (``seq_inner`` on "model": 24 heads do not
    divide 16) and under ``sp``, and rwkv6-1.6b ``decode_32k`` on the
    2×16×16 world, at full size: records with memory, costs and
    collectives."""
    recs = {k: _ok(v, k) for k, v in worlds["production"].items()}
    assert recs["prefill_seq_inner"]["mesh"] == {"data": 16, "model": 16}
    assert recs["decode_pod2"]["mesh"] == {"pod": 2, "data": 16,
                                           "model": 16}
    assert recs["decode_pod2"]["chips"] == 512
    for name, rec in recs.items():
        mem = rec["memory"]
        assert mem["peak_per_device"] == (
            mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
            - mem["alias_bytes"]) > mem["argument_bytes"] > 0, name
        assert rec["artifact_cost_analysis"]["flops"] > 0, name
        assert rec["artifact_collectives"]["count"] > 0, name
    # seq_inner: rank 0's query rows, the first 2048 of 32768, against the
    # gathered K/V; sp: every head whole on every model rank, all rows
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import cost

    layers = get_config("llama3.2-3b").num_layers
    inner = recs["prefill_seq_inner"]["kernels"]["flash_attention"]
    sp = recs["prefill_sp"]["kernels"]["flash_attention"]
    assert inner["launches"] == sp["launches"] == layers
    assert inner["flops"] == layers * cost(2, 24, 8, 2048, 32768, 128, 2)[0]
    assert sp["flops"] == layers * cost(2, 24, 8, 32768, 32768, 128, 2)[0]
    assert "reduce-scatter" not in \
        recs["prefill_seq_inner"]["artifact_collectives"]["by_kind"]
    # the serve step donates its state: the outputs reuse it
    assert recs["decode_pod2"]["memory"]["alias_bytes"] > 0


def test_inner_rows_count_the_pairs_their_mask_lets_through(worlds):
    """(d) B3 at ``seq_inner``'s offset rows: each model rank's flash
    flops are the layers' ``cost`` at its rows' offset, the pairs the
    causal mask lets through, not Sq·Sk."""
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.kernels.flash_attention.kernel import cost
    from repro_torch.models.transformer import DTYPES

    arch, cell, changes = INNER
    cfg = reduced(get_config(arch))
    item = DTYPES[cfg.dtype].itemsize
    shape = ShapeSpec(*cell)
    b = shape.global_batch // 4
    sq = shape.seq_len // 2
    hd = cfg.resolved_head_dim
    for r in RANK_JOBS:
        for rank, rec in worlds[f"sums{r}"]["inner"].items():
            rec = _ok(rec, ("inner", rank))
            m = int(rank) % 2  # the model coordinate on the (4, 2) mesh
            got = rec["kernels"]["flash_attention"]
            want = cost(b, cfg.num_heads, changes["num_kv_heads"], sq,
                        shape.seq_len, hd, item, True, 0, m * sq)
            pairs = sum(m * sq + i + 1 for i in range(sq))
            assert want[0] == 4 * hd * pairs * b * cfg.num_heads
            assert got["flops"] == cfg.num_layers * want[0], (rank, got)
            assert got["bytes"] == cfg.num_layers * want[1], (rank, got)
            assert got["flops"] != cfg.num_layers * 4 * hd * sq \
                * shape.seq_len * b * cfg.num_heads


def _wrappers():
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.kernels.rmsnorm import kernel as b2
    from repro_torch.kernels.wkv import kernel as b4

    f32, bf16 = torch.float32, torch.bfloat16

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype)

    return {
        "rms_norm": (lambda: b2.rms_norm_cuda(z(2, 5, 64, dtype=bf16),
                                              z(64)),
                     b2.cost((2, 5, 64), 2)),
        "rms_norm_backward": (
            lambda: b2.rms_norm_backward_cuda(z(3, 32), z(32), z(3, 32)),
            b2.backward_cost((3, 32), 4)),
        "flash_attention": (
            lambda: b3.flash_attention_cuda(z(2, 4, 8, 16), z(2, 2, 24, 16),
                                            z(2, 2, 24, 16), window=5,
                                            q_offset=9, return_lse=True),
            b3.cost(2, 4, 2, 8, 24, 16, 4, True, 5, 9, lse=True)),
        "flash_attention_backward": (
            lambda: b3.flash_attention_backward_cuda(
                z(1, 4, 40, 64, dtype=bf16), z(1, 1, 40, 64, dtype=bf16),
                z(1, 1, 40, 64, dtype=bf16), z(1, 4, 40, 64, dtype=bf16),
                z(1, 4, 40), z(1, 4, 40, 64, dtype=bf16), causal=False),
            b3.backward_cost(1, 4, 1, 40, 64, 2, False, 0)),
        "wkv": (lambda: b4.wkv_cuda(*[z(2, 3, 7, 16)] * 4, z(3, 16),
                                    z(2, 3, 16, 16)),
                b4.cost(2, 3, 7, 16, True)),
        "wkv_backward": (lambda: b4.wkv_backward_cuda(
            *[z(1, 2, 70, 64)] * 4, z(2, 64), z(1, 2, 70, 64)),
            b4.backward_cost(1, 2, 70, 64)),
    }


@pytest.mark.parametrize("name", sorted(_wrappers()))
def test_kernel_counts_are_their_cost(name, monkeypatch):
    """(d) Under a dry run a wrapper given fake tensors counts one launch
    and its kernel's ``cost``, runs no plain version, and returns fake
    outputs of the kernel's shapes."""
    from repro_torch.kernels._build import counting_kernels, is_fake
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.kernels.rmsnorm import kernel as b2
    from repro_torch.kernels.wkv import kernel as b4

    def refuse(*a, **k):
        raise AssertionError("a plain version ran in a dry run")

    for mod, attrs in ((b2, ("rms_norm_ref", "rms_norm_backward_ref")),
                       (b3, ("attention_ref", "attention_lse_ref")),
                       (b4, ("wkv_ref", "wkv_backward_ref"))):
        for a in attrs:
            monkeypatch.setattr(mod, a, refuse)
    call, (flops, nbytes) = _wrappers()[name]
    with FakeTensorMode(), counting_kernels() as counts:
        out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert all(is_fake(t) for t in outs)
    assert counts == {name: {"launches": 1, "flops": flops,
                             "bytes": nbytes}}
    assert flops > 0 and nbytes > 0


def test_attention_pairs_closed_form():
    """B3's pairs against the mask counted row by row, at offsets, with
    and without a window."""
    from repro_torch.kernels.flash_attention.kernel import attention_pairs

    for sq, sk, off, window in ((8, 8, 0, 0), (8, 24, 9, 5), (16, 64, 48, 0),
                                (5, 40, 30, 100), (7, 7, 0, 3)):
        rows = [min(off + i + 1, window) if window else off + i + 1
                for i in range(sq)]
        assert attention_pairs(sq, True, window, off, sk) == sum(rows)
        assert attention_pairs(sq, False, window, off, sk) == sq * sk


@pytest.mark.parametrize("name", sorted(_wrappers()))
def test_fake_tensor_outside_a_dry_run_raises(name):
    """(g) A fake tensor that reaches a kernel wrapper outside a dry run
    raises: it has neither a kernel nor a count to go to."""
    call, _ = _wrappers()[name]
    with FakeTensorMode(), pytest.raises(RuntimeError,
                                         match="outside a dry run"):
        call()


def test_lower_refuses_without_a_fake_world():
    """(f) ``lower()`` runs only as a rank of a fake world: with no
    process group, or a real one, it raises before running anything."""
    from repro_torch.launch.steps import CellProgram

    ran = []
    prog = CellProgram(fn=lambda: ran.append(1), args=(), in_shardings=(),
                       out_shardings=None, description="a step")
    with pytest.raises(RuntimeError, match="fake world"):
        prog.lower()
    assert not ran


def test_fake_world_refuses_a_second_group():
    """A process has one default group: a fake world does not start
    beside another (here a gloo group of one rank), nor replace it."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as MESH
    from repro_torch.launch.dryrun import fake_world

    started = not dist.is_initialized()
    if started:
        MESH.make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    try:
        backend = dist.get_backend()
        with pytest.raises(RuntimeError, match="process of its own"):
            with fake_world(256):
                pass
        assert dist.get_backend() == backend != "fake"
    finally:
        if started:
            MESH.release_process_group()
