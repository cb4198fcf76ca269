"""The host time of B2's and B4's decode launch paths in two checkouts of
the port, on one card, in turns.

    python3 tools/host_path_ab.py BASE_DIR CHANGE_DIR [--calls N] [--pairs P]
        [--json PATH]

Each directory is the root of a checkout (for example the parent commit
unpacked with ``git archive``). In a fresh process of each checkout, in the
order base, change, change, base (P times), it times ``rms_norm_cuda`` at
the decode shape (8, 1, 3072) bf16 and ``wkv_cuda`` at (8, 32, 1, 64) with
its state updated in place, as ``chip_smoke.py``'s ``rms_host_path`` and
``wkv_host_path`` time their ``wrapper`` step: µs a call by
``time.perf_counter`` over N calls after 100 to warm up, synchronised at
the end, the best of three such timings in a process. It prints, and with
``--json`` writes, each run's µs and each side's best and median, beside
the card's name and power limit. Each process builds its checkout's
kernels at first use. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

RUN = r"""
import json, sys, time
import torch
from repro_torch.kernels.rmsnorm.kernel import rms_norm_cuda
from repro_torch.kernels.wkv.kernel import wkv_cuda

calls = int(sys.argv[1])
g = torch.Generator(device="cuda")
g.manual_seed(0)
x = torch.randn((8, 1, 3072), generator=g, device="cuda").to(torch.bfloat16)
scale = torch.rand((3072,), generator=g, device="cuda") + 0.5
r, k, v = (torch.randn((8, 1, 32, 64), generator=g, device="cuda")
           .transpose(1, 2) * 0.5 for _ in range(3))
lw = -torch.rand((8, 1, 32, 64), generator=g, device="cuda").transpose(1, 2)
u = torch.randn((32, 64), generator=g, device="cuda") * 0.5
state = torch.zeros((8, 32, 64, 64), device="cuda")


def us(step):
    best = float("inf")
    for _ in range(3):
        for _ in range(100):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        best = min(best, 1e6 * (time.perf_counter() - t0) / calls)
    return best


print(json.dumps({"rms_norm_cuda": us(lambda: rms_norm_cuda(x, scale)),
                  "wkv_cuda": us(lambda: wkv_cuda(r, k, v, lw, u, state))}))
"""


def run(root: str, calls: int) -> dict:
    env = {**os.environ, "PYTHONPATH": "src"}
    out = subprocess.run([sys.executable, "-c", RUN, str(calls)], cwd=root,
                         env=env, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"the host path run in {root} failed:\n"
                           f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("base")
    parser.add_argument("change")
    parser.add_argument("--calls", type=int, default=10_000)
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--json", help="also write the results here")
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[:1]
    order = (("base", args.base), ("change", args.change),
             ("change", args.change), ("base", args.base)) * args.pairs
    runs = [(side, run(root, args.calls)) for side, root in order]
    names = ("rms_norm_cuda", "wkv_cuda")
    result = {"card": card[0] if card else "not read", "calls": args.calls,
              "runs": [{"side": side, **us} for side, us in runs]}
    for stat, fn in (("best_us", min), ("median_us", statistics.median)):
        result[stat] = {side: {name: fn([us[name] for s, us in runs
                                         if s == side]) for name in names}
                        for side in ("base", "change")}
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
