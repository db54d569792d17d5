"""What the drivers share: the port's Config from a configuration file,
the wrappers around the port's functions (what the check reads, and a
traced run's spans), and the control's TF32 products."""

from __future__ import annotations

import collections
import importlib
from typing import Callable, NamedTuple, Optional

import torch


def controller_config(config: dict):
    """The port's Config from the configuration file's controller
    section (lists back to tuples)."""
    from qrw_tpu_torch.config import Config
    ctrl = config["controller"]
    return Config(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in ctrl.items()})


class Hook(NamedTuple):
    """A function that the port looks up at call time, as a module
    attribute (such as `qrw_tpu_torch.sim.fleet.step_lane`)."""
    name: str
    module: str
    attr: str
    record: Optional[Callable] = None   # (args, kwargs, result) -> kept
    keep: Optional[int] = 1             # calls kept (None: all, 0: none)


class Wrappers:
    """Replaces each hook's module attribute with a wrapper; `remove` puts
    the originals back. `calls[name]` keeps what the hook's latest `keep`
    calls produced: `record(args, kwargs, result)`, or the triple itself
    (references only: no copy). With `sync`, each call is also a span: it
    synchronizes the card before and after the call, inside a
    `torch.profiler.record_function("span:<name>")` range."""

    def __init__(self, hooks, sync=None):
        self.calls = {}
        self._saved = []
        for h in hooks:
            self.calls[h.name] = collections.deque(maxlen=h.keep)
            mod = importlib.import_module(h.module)
            orig = getattr(mod, h.attr)
            setattr(mod, h.attr, self._wrap(h, orig, sync))
            self._saved.append((mod, h.attr, orig))

    def latest(self, name):
        return self.calls[name][-1]

    def _wrap(self, h, orig, sync):
        kept = self.calls[h.name]
        record = h.record or (lambda a, kw, out: (a, kw, out))

        def call(args, kwargs):
            if sync is None:
                return orig(*args, **kwargs)
            sync()
            with torch.profiler.record_function("span:" + h.name):
                out = orig(*args, **kwargs)
                sync()
            return out

        def wrapper(*args, **kwargs):
            out = call(args, kwargs)
            if kept.maxlen != 0:
                kept.append(record(args, kwargs, out))
            return out
        wrapper.__wrapped__ = orig
        return wrapper

    def clear(self):
        for kept in self.calls.values():
            kept.clear()

    def remove(self):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []


def max_gap(a, b) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


class tf32_products:
    """TF32 matrix products on the card while the control runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def warm_rescue(call):
    """Run the MPC's rescue stage once on the inputs of the latest phase
    solve `call` (from `Wrappers`), every lane marked failed, so that the
    stage's kernels and library calls are loaded and initialised in
    set-up: in the window it fires only on cycles with failures."""
    from qrw_tpu_torch.core import mpc_lane as ml
    a, kw, (_, st, sol) = call
    cap = kw.get("rescue_cap", 0)
    if not cap:
        return
    ps = a[3]
    failed = sol._replace(converged=torch.zeros_like(sol.converged))
    ml._rescue_failed_lanes(a[0], a[1], a[2], st.f, st.y, failed, cap,
                            kw.get("rescue_settings"),
                            c_scale=ps.data.c_scale, qp_cap=ps.cap,
                            warm_state=st)
