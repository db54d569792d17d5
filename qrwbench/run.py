"""The benchmark's command: one run of one cell on the card.

    python3 -m qrwbench.run --workload NAME --seed N --seconds S --trace 0|1

Prints, as the last line of standard output, one JSON object with the
keys correct, attempted, failed, metrics, device (and breakdown with
--trace 1), then `checks`: each number compared beside its limit, which
also close standard error. Exits 2 without a result when the card is
missing or too few cards are present, and 3 when a module of JAX or of
the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

PYCACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".qrwbench_cache", "pyc")


def cache_bytecode():
    """Cache the compiled bytecode of every module the run imports
    (PyTorch's takes seconds to compile) at a fixed path inside the
    checkout, also where the environment turns bytecode writing off:
    only the first run in a checkout compiles it."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = PYCACHE

FORBIDDEN = ("jax", "jaxlib", "flax", "qrw_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (qrw_tpu_torch is not qrw_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m qrwbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from qrwbench import harness
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    workload = cells[args.workload]

    import torch
    marks = [("torch_s", time.perf_counter())]
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < workload["chips"]:
        print(f"{workload['name']} needs {workload['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2

    # one host thread for the port's CPU-side operations: their pool's
    # spinning threads would contend with the issuing thread
    torch.set_num_threads(1)
    torch.zeros((), device="cuda")
    marks.append(("context_s", time.perf_counter()))
    result, checks = harness.run_cell(bench, workload, args.seed,
                                      args.seconds, bool(args.trace),
                                      "cuda", T_START, marks=marks)
    bad = forbidden_modules()
    if bad:
        print("loaded modules of JAX or the JAX package: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    sys.stdout.flush()
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    cache_bytecode()
    sys.exit(main())
