"""The port's spans and counters (qrw_tpu_torch/utils/profiling).

Under a CPU-only torch profiler, the heterogeneous fleet of
tests/test_torch_fleet_hetero.py (B = 6, tile 1, rescue_cap = 2; one
full cycle and one crippled cycle whose 1-iteration phase solve fails
every lane, so the rescue re-solves two), a warm "ns" call of the
full-size batch at B = 4, a cold and a warm DDP MPC solve of four trot
phases and ten ticks of the single-robot loop open every layer span,
properly nested under the span named as its parent; the counters equal
what the logs imply; and the outputs are bitwise
those of the same calls with no profiler. With no profiler the facility
does nothing: no counter, no torch operation, no profiler range.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from qrw_tpu_torch.config import Config
from qrw_tpu_torch.core import mpc as tmpc
from qrw_tpu_torch.core import mpc_ddp
from qrw_tpu_torch.core.mpc_lane import trot_phase_fsteps
from qrw_tpu_torch.eval.kernel_profile import build_batch
from qrw_tpu_torch.ops import qp
from qrw_tpu_torch.sim import fleet as tfl
from qrw_tpu_torch.sim import rollout as tro
from qrw_tpu_torch.utils import op_count, profiling
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
B = 6
KW = dict(gaits=("trot", "walk", "bounding"), velIDs=(0, 2),
          terrain_ids=(0, 1), seed=3)

# span -> the span that immediately encloses every one of its openings
# (None: opened by the caller, outside any port span)
FLEET_PARENTS = {
    "fleet.fk": None, "pre": None, "mpc.phase": None, "wbc": None,
    "physics": None, "post": None,
    "mpc.assemble": "mpc.phase", "mpc.warm": "mpc.phase",
    "mpc.k1": "mpc.phase", "mpc.guard": "mpc.phase",
    "mpc.rescue": "mpc.phase", "mpc.plan": "mpc.phase",
    "rescue.select": "mpc.rescue", "reduced": "mpc.rescue",
    "rescue.patch": "mpc.rescue", "sync.rescue_any": "rescue.select",
    "reduced.build": "reduced", "qp.solve": "reduced",
    "reduced.plan": "reduced", "qp.cone_check": "qp.solve",
    "sync.qp_cone_check": "qp.cone_check", "qp.precondition": "qp.solve",
    "qp.factor": "qp.solve", "qp.k2": "qp.solve", "qp.rho": "qp.solve",
    "sync.qp_early_exit": "qp.solve",
    "wbc.ik": "wbc", "wbc.qp_data": "wbc", "wbc.qp": "wbc",
    "wbc.torques": "wbc", "wbc.qp.factor": "wbc.qp",
    "wbc.qp.iterate": "wbc.qp", "sync.wbc_qp_done": "wbc.qp",
    "sync.wbc_qp_dG": "wbc.qp",
    "physics.control": "physics", "physics.contact": "physics",
    "physics.dynamics": "physics", "physics.integrate": "physics",
    "physics.measure": "physics",
    "sync.fleet_cycle": None, "sync.fleet_phase_offsets": None,
    "sync.pre_shoulders": "pre", "sync.post_security": "post",
    "sync.mpc_assembly_constants": "mpc.assemble",
    "sync.mpc_cone": "reduced.build",
}
FULLSIZE_PARENTS = {
    "fullsize": None, "fullsize.build": "fullsize", "qp.solve": "fullsize",
    "fullsize.plan": "fullsize", "qp.cone_check": "qp.solve",
    "qp.precondition": "qp.solve", "qp.factor": "qp.solve",
    "qp.k3": "qp.factor", "qp.k2": "qp.solve", "qp.rho": "qp.solve",
    "sync.mpc_cone": "fullsize.build",
}
DDP_PARENTS = {
    "ddp": None, "ddp.setup": "ddp", "ilqr": "ddp", "ilqr.rollout": "ilqr",
    "ilqr.derivs": "ilqr", "ilqr.backward": "ilqr", "ilqr.linesearch": "ilqr",
    "ilqr.accept": "ilqr",
}
SINGLE_PARENTS = {"pre": None, "mpc": None, "post": None, "wbc": "post",
                  "physics": None}


def _spans(prof):
    """(start, end, name) of the port's spans, name without its prefix."""
    return [(e.start_ns(), e.end_ns(), e.name()[len(profiling.PREFIX):])
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(profiling.PREFIX)]


def _parents(spans):
    """{name: set of the names that immediately enclose its openings};
    asserts that the spans nest properly."""
    out, stack = {}, []
    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:
            assert e <= stack[-1][1], (n, "overlaps", stack[-1][2])
        out.setdefault(n, set()).add(stack[-1][2] if stack else None)
        stack.append((s, e, n))
    return out


def _leaves(tree):
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def _run_fleet(wbc_iters=None):
    """The two cycles from the same initial carry; with `wbc_iters`, the
    lane WBC's qp_iters of every tick are appended to it."""
    ctl, carry, ps, ter, meta = tfl.make_hetero_fleet(CFG, B, tile=1,
                                                      device="cpu", **KW)
    sched = tfl.hetero_v_ref_schedule(CFG, meta.velID, 2 * CFG.k_mpc,
                                      device="cpu")
    kw = dict(tile=1, rescue_cap=2, perfect_estimator=False,
              stop_at_eps=False, phase_offsets=meta.phase_offsets,
              phase_periods=meta.phase_periods, terrain=ter)
    T = CFG.k_mpc
    with pytest.MonkeyPatch.context() as mp:
        if wbc_iters is not None:
            orig = tfl.compute_wbc_lane

            def record(*a, **k):
                res = orig(*a, **k)
                wbc_iters.append(res.qp_iters)
                return res
            mp.setattr(tfl, "compute_wbc_lane", record)
        c1 = tfl.fleet_rollout(ctl, carry, 1, ps, n_iters=300,
                               v_ref_schedule=sched[:T], **kw)
        c2 = tfl.fleet_rollout(ctl, c1[0], 1, ps, n_iters=1,
                               v_ref_schedule=sched[T:], **kw)
    return [c1, c2]


@pytest.fixture(scope="module")
def fleet():
    profiling.reset()
    plain = _run_fleet()
    unprofiled_counters = profiling.counters()
    iters = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _run_fleet(iters)
    counts = profiling.counters()
    profiling.reset()
    return dict(plain=plain, traced=traced, spans=_spans(prof),
                counts=counts, wbc_iters=iters,
                unprofiled_counters=unprofiled_counters)


@pytest.fixture(scope="module")
def fullsize():
    xr, fs = (torch.as_tensor(a) for a in
              build_batch(CFG, 4, np.random.default_rng(0)))
    st = qp.QPSettings(eps_abs=1e-4, eps_rel=1e-4, max_iter=450,
                       adaptive_rho_interval=200)
    _, cold, _ = tmpc.solve_mpc_batch_pallas(CFG, xr, fs, settings=st)
    warm = lambda: tmpc.solve_mpc_batch_pallas(  # noqa: E731
        CFG, xr, fs, state=cold, settings=st, refactor="ns", schedule=[50])
    plain = warm()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = warm()
    profiling.reset()
    return dict(plain=plain, traced=traced, spans=_spans(prof))


@pytest.fixture(scope="module")
def ddp():
    """A cold and a warm DDP MPC solve of four trot phases (float32), and
    each solve's cost before its first iteration: a solve whose only
    step size is infinite rejects every step."""
    xr = torch.zeros((4, 12, CFG.n_steps + 1))
    xr[:, 2] = CFG.h_ref
    xr[:, 6, 1:] = torch.tensor([0.1, 0.3, 0.5, 0.7])[:, None]
    fs = torch.as_tensor(trot_phase_fsteps(CFG)[[0, 3, 8, 13]])

    def solves(settings=mpc_ddp.DDPSettings(), carried=None):
        cold = mpc_ddp.solve_mpc_ddp(CFG, xr, fs, None, settings)
        carried = cold.state if carried is None else carried
        return [cold, mpc_ddp.solve_mpc_ddp(CFG, xr, fs.roll(1, 1), carried,
                                            settings)]
    profiling.reset()
    plain = solves()
    start = [r.cost for r in solves(
        mpc_ddp.DDPSettings(max_iters=1, alphas=(float("inf"),)),
        plain[0].state)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = solves()
    counts = profiling.counters()
    profiling.reset()
    return dict(plain=plain, traced=traced, spans=_spans(prof),
                counts=counts, start=start, inputs=(xr, fs))


@pytest.mark.parametrize("path", ["fleet", "fullsize", "single", "ddp"])
def test_every_span_opens_under_its_parent(path, request):
    if path == "single":
        ctl, carry = tro.make_rollout(CFG, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tro.rollout(ctl, carry, 10, with_logs=False)
        profiling.reset()
        spans, want = _spans(prof), SINGLE_PARENTS
    else:
        spans = request.getfixturevalue(path)["spans"]
        want = {"fleet": FLEET_PARENTS, "fullsize": FULLSIZE_PARENTS,
                "ddp": DDP_PARENTS}[path]
    got = _parents(spans)
    for name, parent in want.items():
        assert got.get(name) == {parent}, (name, got.get(name))
    # every other layer span of the path is named above; the WBC's
    # inputs are assembled once before the lane WBC, once in the post step
    assert {n for n in got if not n.startswith("sync.")} - set(want) \
        <= {"wbc.inputs"}
    assert got.get("wbc.inputs", {None}) <= {None, "post"}


@pytest.mark.parametrize("path", ["fleet", "fullsize", "ddp"])
def test_outputs_bitwise_equal_with_the_profiler(path, request):
    r = request.getfixturevalue(path)
    got, want = _leaves(r["traced"]), _leaves(r["plain"])
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_rescued_counter_is_the_logs_sum(fleet):
    """The rescued lanes, and the problems that the rescue's factor
    inverted: its R = rescue_cap = 2 lanes in each round's `qp.factor`
    (no read of the factor's status, so no `sync.qp_*` span in it), none
    of them set to NaN."""
    logs = [cl for _, _, cl in fleet["traced"]]
    rescued = sum(int(cl.rescued.sum()) for cl in logs)
    assert rescued == 2                       # the crippled cycle's two
    assert fleet["counts"]["mpc.rescued"] == rescued
    rounds = sum(1 for *_, m in fleet["spans"] if m == "qp.factor")
    assert rounds >= 1
    assert fleet["counts"]["qp.kinv_lanes"] == 2 * rounds
    assert fleet["counts"]["qp.kinv_nonpd"] == 0
    assert not any(m.startswith("sync.qp_chol") for *_, m in fleet["spans"])


def test_k1_counters_are_the_tile_maxima(fleet):
    logs = [cl for _, _, cl in fleet["traced"]]
    tile_max = torch.cat([cl.iters.reshape(len(cl.iters), -1, 1)
                          .amax(dim=-1).flatten() for cl in logs])
    assert fleet["counts"]["mpc.k1_tiles"] == tile_max.numel() == 2 * B
    assert fleet["counts"]["mpc.k1_tile_iters"] == int(tile_max.sum())


def test_ilqr_counters_are_problems_and_accepted_steps(ddp):
    """`ilqr.problems` counts problems x iterations of both solves;
    `ilqr.accepted` the iterations whose best step lowered a problem's
    cost: where the accepted cost of the trace falls (a rejected
    iteration leaves it equal). No host read: no `sync.*` span opens."""
    c = ddp["counts"]
    assert c["ilqr.problems"] == 2 * 4 * 10
    acc = [int((r.cost_trace[:, 0] < c0).sum())
           + int((r.cost_trace[:, 1:] < r.cost_trace[:, :-1]).sum())
           for r, c0 in zip(ddp["traced"], ddp["start"])]
    assert c["ilqr.accepted"] == sum(acc)
    assert 0 < acc[1] < 40
    assert not any(m.startswith("sync.") for *_, m in ddp["spans"])


def test_a_ddp_solve_makes_no_tensor_from_host_data(ddp):
    """The DDP MPC's constants (the model's, the step sizes, the identity)
    come from their caches once made: a solve dispatches no `lift_fresh`,
    the operation of a tensor made from host data, which on the card is
    a copy that blocks the host until the stream drains."""
    ops = collections.Counter()

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    xr, fs = ddp["inputs"]
    with Ops():
        mpc_ddp.solve_mpc_ddp(CFG, xr, fs, ddp["plain"][0].state)
    assert sum(ops.values()) > 1000
    assert ops["aten.lift_fresh.default"] == 0


def test_wbc_rounds_are_those_of_qp_iters(fleet):
    """A round runs check_every (25) iterations on every lane not yet
    done, and the QP stops when the slowest lane is: a tick's rounds are
    its most iterations over 25."""
    ticks = fleet["wbc_iters"]
    assert len(ticks) == 2 * CFG.k_mpc
    rounds = sum(int(it.max()) // 25 for it in ticks)
    assert rounds > len(ticks)
    assert fleet["counts"]["wbc.qp_rounds"] == rounds


def test_host_reads_are_counted_by_site(fleet):
    c = fleet["counts"]
    n = {n: sum(1 for *_, m in fleet["spans"] if m == n)
         for n in ("sync.wbc_qp_done", "sync.rescue_any", "sync.fleet_cycle")}
    for name, opened in n.items():
        assert opened > 0 and c[name] == opened
    assert c["sync.fleet_cycle"] == 2 and c["sync.rescue_any"] == 2


def test_nothing_without_a_profiler(fleet, monkeypatch):
    assert fleet["unprofiled_counters"] == {}
    t = torch.tensor(3)
    ops = op_count.count_ops(lambda: (profiling.count("x", t),
                                      profiling.count("y", 2)))
    assert sum(ops.values()) == 0
    assert profiling.counters() == {}

    def refuse(*a, **k):
        raise AssertionError("record_function with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("x"), profiling.host_read("y"):
        pass
    xr, fs = (torch.as_tensor(a) for a in
              build_batch(CFG, 2, np.random.default_rng(1)))
    tmpc.solve_mpc_batch_reduced(CFG, xr, fs)
    assert profiling.counters() == {}
