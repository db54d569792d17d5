"""The control of `correct`: the plain references computed at TF32
precision, put in the port's place, must come out as not correct.

    python3 -m qrwbench.control --workload NAME --seeds 1 2 3 --cycles 3

For each seed it builds the cell at its own size, runs the set-up's
warm-up and `--cycles` cycles of the port, then prints one JSON line
with the numbers compared for the port's answers ("program") and for
the control's answers to the same inputs ("control"), beside the
cell's limits. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys


def readings(bench: dict, workload: dict, seed: int, cycles: int, device,
             overrides=None) -> dict:
    import torch
    from qrwbench import harness
    cell = harness.make_cell(bench, workload, seed, device, overrides)
    try:
        cell.warm()
        for _ in range(cycles):
            cell.cycle()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return {"seed": seed, "program": cell.gaps(seed),
                "control": cell.gaps(seed, control=True),
                "limits": cell.traffic["limits"]}
    finally:
        cell.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m qrwbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cycles", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    from qrwbench import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    workload = {w["name"]: w for w in bench["workloads"]}[args.workload]
    for seed in args.seeds:
        out = readings(bench, workload, seed, args.cycles, "cuda")
        print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
