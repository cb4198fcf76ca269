"""The port's dry run (``repro_torch.launch.dryrun``) on fake worlds, in a
process of its own, so that its fake default process group never meets a
test worker's group (a process has one).

    python tests/_torch_dryrun_world.py JOB OUT.json [ARG]

Jobs (each writes one JSON object to OUT.json; a cell that raises is
recorded as ``{"status": "error", ...}``):

- ``sums RANKS``: the five cells of the reference's
  ``tests/test_dryrun_small.py`` (``SMALL``), reduced, accum 2 where they
  train, as each rank of ``RANKS`` (comma separated) of a fake (4, 2)
  world, and on a fake world of one rank (1×1), with the kernels' plain
  versions made to raise; and reduced llama3.2-3b prefills under the
  ``seq_inner`` override at each rank;
- ``probes``: ``probe_costs`` against a full-depth, full-accumulation run
  of the same cell on the fake (4, 2) world, rank 0 (``PROBED``);
- ``production``: llama3.2-3b ``prefill_32k`` on the 16×16 world under
  ``rules_for``'s layout (``seq_inner`` on "model") and under ``sp``, and
  rwkv6-1.6b ``decode_32k`` on the 2×16×16 world, at full size, no probes
  (``run_cell``);
- ``gloo``: the gloo world's ``ISSUED_CELLS`` (``_torch_mesh_world.py``,
  its configs and rules) at each rank of a fake (2, 2) world.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

SMALL = [("llama3.2-3b", ("t", "train", 32, 8)),
         ("mixtral-8x7b", ("p", "prefill", 64, 4)),
         ("rwkv6-1.6b", ("d", "decode", 64, 4)),
         ("zamba2-7b", ("d", "decode", 64, 4)),
         ("seamless-m4t-medium", ("t", "train", 32, 8))]
# (name, arch, cell, config changes): llama at accum 4 and 8 (the
# accumulation split, probed at 2 and 4; 4 rows a microbatch, one a data
# rank, at accum 4 and 8 alike, more at 2), zamba2 at 2 groups and a tail layer (the hybrid's groups and
# its tail probe), seamless at accum 2 (enc-dec's two deltas)
PROBED = [("llama_train_accum4", "llama3.2-3b", ("t", "train", 32, 16),
           {"accum": 4}),
          ("llama_train_accum8", "llama3.2-3b", ("t", "train", 32, 32),
           {"accum": 8}),
          ("zamba2_decode_tail", "zamba2-7b", ("d", "decode", 64, 4),
           {"num_layers": 5}),
          ("seamless_train", "seamless-m4t-medium", ("t", "train", 32, 8),
           {"accum": 2})]
# the inner prefill (the override's GQA, as the gloo world's)
INNER = ("llama3.2-3b", ("p", "prefill", 32, 4), {"num_kv_heads": 2})
PRODUCTION = [("prefill_seq_inner", "llama3.2-3b", "prefill_32k", False,
               None),
              ("prefill_sp", "llama3.2-3b", "prefill_32k", False,
               {"seq_inner": None}),
              ("decode_pod2", "rwkv6-1.6b", "decode_32k", True, None)]


def no_plain_versions() -> None:
    """Make every kernel's plain version raise: under a dry run the
    wrappers run neither a kernel nor its plain version."""
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.kernels.flash_attention import ops as b3ops
    from repro_torch.kernels.rmsnorm import kernel as b2
    from repro_torch.kernels.wkv import kernel as b4

    def refuse(name):
        def plain(*a, **k):
            raise AssertionError(f"{name}: a plain version ran in a dry run")
        return plain

    for mod, names in ((b2, ("rms_norm_ref", "rms_norm_backward_ref")),
                       (b3, ("attention_ref", "attention_lse_ref")),
                       (b3ops, ("flash_attention_backward",)),
                       (b4, ("wkv_ref", "wkv_backward_ref"))):
        for n in names:
            setattr(mod, n, refuse(n))


def _reduced(arch: str, cell: tuple, **changes):
    from repro_torch.configs import ShapeSpec, get_config, reduced

    shape = ShapeSpec(*cell)
    changes = {"accum": 2 if shape.kind == "train" else 1, **changes}
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    return cfg, shape


def _guarded(fn):
    import traceback

    try:
        return {"status": "ok", **fn()}
    except Exception as e:  # recorded; the test fails on it
        return {"status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-3000:]}


def sums(ranks: list[int]) -> dict:
    from repro_torch.launch.dryrun import dry_run

    out: dict = {"cells": {}, "one_device": {}, "inner": {}}
    for arch, cell in SMALL:
        cfg, shape = _reduced(arch, cell)
        key = f"{arch}/{cell[1]}"
        out["cells"][key] = {
            str(r): _guarded(lambda r=r: dry_run(cfg, shape, (4, 2),
                                                 rank=r))
            for r in ranks}
        if ranks[0] == 0:
            out["one_device"][key] = _guarded(
                lambda: dry_run(cfg, shape, (1, 1)))
    arch, cell, changes = INNER
    cfg, shape = _reduced(arch, cell, **changes)
    out["inner"] = {str(r): _guarded(lambda r=r: dry_run(
        cfg, shape, (4, 2), rank=r, overrides={"seq_inner": "model"}))
        for r in ranks}
    return out


def probes() -> dict:
    from repro_torch.launch.dryrun import fake_world, probe_costs, summary, \
        _lower
    from repro_torch.launch.mesh import make_mesh_compat

    out = {}
    for name, arch, cell, changes in PROBED:
        cfg, shape = _reduced(arch, cell, **changes)

        def one():
            with fake_world(8, 0):
                mesh = make_mesh_compat((4, 2), ("data", "model"),
                                        device="cpu")
                full = summary(_lower(cfg, shape, mesh, None)[0])
                probe = probe_costs(cfg, shape, mesh, None)
            return {"full": full, "probe": probe}
        out[name] = _guarded(one)
    return out


def production() -> dict:
    from repro_torch.launch.dryrun import run_cell

    return {name: _guarded(lambda: run_cell(
                arch, shape, multi_pod=pod, skip_probes=True,
                overrides=over))
            for name, arch, shape, pod, over in PRODUCTION}


def gloo() -> dict:
    from _torch_mesh_world import ISSUED_CELLS, RULES, _config, cell_key

    from repro_torch.launch.dryrun import dry_run

    out = {}
    for arch, cell, variant in ISSUED_CELLS:
        cfg, shape, compress = _config(arch, cell, variant)
        assert not compress, "the dry run runs build_cell_program's steps"
        out[cell_key(arch, cell, variant)] = {
            str(r): _guarded(lambda r=r: dry_run(
                cfg, shape, (2, 2), rank=r, overrides=RULES.get(variant)))
            for r in range(4)}
    return out


def main(job: str, out_path: str, arg: str = "") -> None:
    import torch

    torch.set_num_threads(1)
    warnings.simplefilter("ignore", FutureWarning)
    no_plain_versions()
    if job == "sums":
        res = sums([int(r) for r in arg.split(",")])
    elif job == "probes":
        res = probes()
    elif job == "production":
        res = production()
    elif job == "gloo":
        res = gloo()
    else:
        raise SystemExit(f"unknown job {job!r}")
    with open(out_path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
