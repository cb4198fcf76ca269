"""Training steps of two checkouts of the port on one card, in turns.

    python3 tools/train_step_ab.py BASE_DIR CHANGE_DIR [--arch ARCH ...]
        [--steps N] [--json PATH]

Each directory is the root of a checkout (for example the parent commit
unpacked with ``git archive``). For every architecture it runs
``repro_torch.launch.train.train(arch, use_reduced=False, steps=N,
global_batch=2, seq_len=2048)`` in a fresh process of each checkout, in the
order base, change, change, base, so that both sides see the card warm and
cold alike, and reads the step times that ``train`` logs. It prints, and
with ``--json`` writes, each run's step ms and each side's median over the
steps after the first of its runs, beside the card's name and power limit.
Each process builds its checkout's kernels at first use. Needs a CUDA
card; the archs must fit it at full depth (the smoke's cut depths are not
applied here).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

RUN = ("import sys; from repro_torch.launch.train import train; "
       "train(sys.argv[1], use_reduced=False, steps=int(sys.argv[2]), "
       "global_batch=2, seq_len=2048, log_every=1)")


def steps_ms(root: str, arch: str, steps: int) -> list[int]:
    """The ms of each step of one ``train`` run in checkout ``root``."""
    env = {**os.environ, "PYTHONPATH": "src"}
    out = subprocess.run([sys.executable, "-c", RUN, arch, str(steps)],
                         cwd=root, env=env, capture_output=True, text=True)
    ms = [int(m) for m in re.findall(r"\((\d+) ms\)", out.stdout)]
    if out.returncode or len(ms) != steps:
        raise RuntimeError(f"train {arch} in {root} failed:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return ms


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("base")
    parser.add_argument("change")
    parser.add_argument("--arch", action="append", dest="archs")
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--json", help="also write the results here")
    args = parser.parse_args()
    archs = args.archs or ["llama3.2-3b", "rwkv6-1.6b", "seamless-m4t-medium"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[:1]
    result = {"card": card[0] if card else "not read", "steps": args.steps,
              "archs": {}}
    for arch in archs:
        runs = []
        for side in ("base", "change", "change", "base"):
            ms = steps_ms(getattr(args, side), arch, args.steps)
            runs.append({"side": side, "step_ms": ms})
            print(arch, side, ms, flush=True)
        result["archs"][arch] = {
            "runs": runs,
            "median_ms_after_first": {
                side: statistics.median(
                    m for r in runs if r["side"] == side
                    for m in r["step_ms"][1:])
                for side in ("base", "change")}}
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
