"""Not a test: the host's blocking reads of the card in one cycle of each
benchmark cell, as `torch.cuda.set_sync_debug_mode("warn")` lists them.

    python tests/torch_sync_sites.py [CELL ...] [--out PATH]

Builds each cell as `qrwbench.run` does (its configuration, traffic and
size; seed 7), warms it up, then runs one cycle with the sync debug mode
on. Each warning is traced to its innermost frame in qrw_tpu_torch (or
in the benchmark's own code where no port frame is on the stack) and
printed with how often it fired and whether it fired inside a
`utils/profiling.host_read` span (`qrw.sync.<site>`). A site outside
every such span is a library call that synchronizes on its own (name it)
or a read to wrap. Also prints the cycle's launches of the K^-1 kernel,
of the DDP derivatives kernel (one an iLQR iteration) and of the DDP
line-search kernel (one a solve's initial rollout and one an
iteration), as `kernels.launches()` counts them, and how many
of the synchronizing calls fired inside the DDP solver's span
`qrw.ilqr` (the DDP cell's target is none). With --out, also writes
the sites as JSON to PATH.
Needs the card.
"""

import collections
import json
import os
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from qrwbench import harness  # noqa: E402
from qrw_tpu_torch import kernels  # noqa: E402
from qrw_tpu_torch.utils import profiling  # noqa: E402

PORT = os.path.join(ROOT, "qrw_tpu_torch")
BENCH = os.path.join(ROOT, "qrwbench")


def track_host_reads():
    """A stack of the host_read sites open now (with or without a
    profiler)."""
    open_sites = []
    enter, exit_ = profiling.host_read.__enter__, profiling.host_read.__exit__

    def on_enter(self):
        open_sites.append(self.name)
        return enter(self)

    def on_exit(self, *exc):
        open_sites.pop()
        return exit_(self, *exc)
    profiling.host_read.__enter__ = on_enter
    profiling.host_read.__exit__ = on_exit
    return open_sites


def track_spans():
    """A stack of the port's spans open now (with or without a
    profiler), host reads included."""
    open_spans = []
    enter, exit_ = profiling.span.__enter__, profiling.span.__exit__

    def on_enter(self):
        open_spans.append(self.name)
        return enter(self)

    def on_exit(self, *exc):
        open_spans.pop()
        return exit_(self, *exc)
    profiling.span.__enter__ = on_enter
    profiling.span.__exit__ = on_exit
    return open_spans


def site_of(stack):
    """(file:line, code, function) of the innermost frame of the port, else
    of the benchmark, else the innermost frame."""
    for root in (PORT, BENCH):
        for fr in reversed(stack):
            if fr.filename.startswith(root) and fr.filename != __file__:
                rel = os.path.relpath(fr.filename, ROOT)
                return f"{rel}:{fr.lineno}", (fr.line or "").strip(), fr.name
    fr = stack[-1]
    where = " < ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                       for f in reversed(stack[-6:]))
    return f"{fr.filename}:{fr.lineno}", where, fr.name


def main(argv):
    out = None
    if "--out" in argv:
        i = argv.index("--out")
        out = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    names = argv or list(cells)
    open_spans = track_spans()      # first: host_read's exit calls span's
    open_sites = track_host_reads()
    torch.set_num_threads(1)
    report = {}
    for name in names:
        cell = harness.make_cell(bench, cells[name], 7, "cuda")
        cell.warm()
        torch.cuda.synchronize()
        hits = collections.Counter()
        in_ilqr = collections.Counter()
        inside = {}
        code = {}

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" not in str(message):
                return
            site, text, fn = site_of(traceback.extract_stack()[:-1])
            key = (site, fn)
            hits[key] += 1
            in_ilqr[key] += "ilqr" in open_spans
            inside.setdefault(key, set()).add(open_sites[-1] if open_sites
                                              else None)
            code[key] = text

        saved = warnings.showwarning
        warnings.showwarning = show
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    cell.cycle()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        finally:
            warnings.showwarning = saved
        wall = time.perf_counter() - t0
        kinv = kernels.launches("qrw_kinv").total()
        derivs = kernels.launches("qrw_ddp_derivs").total()
        searches = kernels.launches("qrw_ddp_linesearch").total()
        cell.close()
        rows = []
        for (site, fn), n in sorted(hits.items(), key=lambda kv: -kv[1]):
            spans = sorted(s or "-" for s in inside[(site, fn)])
            rows.append({"site": site, "function": fn, "code": code[(site, fn)],
                         "count": n, "host_read": spans,
                         "in_ilqr": in_ilqr[(site, fn)]})
        report[name] = {"cycle_s": wall, "sites": rows,
                        "kinv_launches": kinv,
                        "derivs_launches": derivs,
                        "linesearch_launches": searches,
                        "in_ilqr": sum(in_ilqr.values())}
        print(f"== {name}: one cycle {wall:.3f} s, "
              f"{sum(hits.values())} synchronizing calls at {len(rows)} "
              f"sites, {kinv} K^-1 launches, {derivs} DDP derivatives "
              f"and {searches} DDP line-search launches, "
              f"{sum(in_ilqr.values())} inside qrw.ilqr", flush=True)
        for r in rows:
            mark = "ok " if "-" not in r["host_read"] else "OUT"
            print(f"  {mark} {r['count']:5d}  {r['site']}  {r['function']}: "
                  f"{r['code']}  [{', '.join(r['host_read'])}]",
                  flush=True)
        del cell
        torch.cuda.empty_cache()
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
