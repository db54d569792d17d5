"""The DDP backends in the closed loop against qrw_tpu: the controller
and the rollout with type_MPC = False and with mpc_planner, the
every-tick DDP's wiring, eval/compare and the CLI's --ddp and
analyze --compare.

JAX builds the rollout's initial carry (sim/rollout.make_rollout; the
DDPState or PlannerState rides in it), broadcast to B = 2 robots whose
joint angles are perturbed by np.random.default_rng(0).normal(scale=
0.01), as qrw_tpu's CLI does for --batch; the carry goes to the port
through qrw_tpu_torch.convert. qrw_tpu runs jax.vmap(rollout) for 21
ticks (DDP solves at k = 0, 10 and 20), the port its rollout along the
batch axis, in float64 with the perfect estimator: one JAX compile per
config.

Tolerances: every log leaf and every leaf of the final carry to 1e-9 of
its scale, max(1, |leaf|), except the MPC plan and warm start (x_f_mpc;
the carry's x_f_mpc, x_f_next and mpc), held to 1e-7 of scale: near
their optimum the iLQR's steps lower the cost by one ulp and the two
packages may decide such a step differently (tests/test_torch_ddp.py's
docstring; ROADMAP queue 3). Measured: the k = 10 solve of the DDP run
differs there (qrw_tpu accepts at iteration 5 a step that lowers the
cost 0.26829039265748844 by one ulp, the port does not), which moves the
plan's last node by 4.8e-8 N (2.8e-9 of scale); every other leaf within
3e-10 of scale (planner run: 6e-10 on the carry)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.eval import compare as jcmp
from qrw_tpu.sim import rollout as jro
from qrw_tpu_torch import convert
from qrw_tpu_torch.config import Config as TConfig
from qrw_tpu_torch.core import mpc_ddp as tddp
from qrw_tpu_torch.core import mpc_ddp_planner as tpl
from qrw_tpu_torch.eval import analyze as tan
from qrw_tpu_torch.eval import compare as tcmp
from qrw_tpu_torch.sim import rollout as tro
from tests.torch_threads import single_thread

single_thread()

B = 2
N_TICKS = 21
CONFIGS = {"ddp": dict(type_MPC=False), "planner": dict(mpc_planner=True)}
# the plan and warm start held to 1e-7: the log leaf x_f_mpc, and the
# carry's x_f_mpc, x_f_next and every leaf of its mpc state
PLAN_LEAVES = ("x_f_mpc", "x_f_next", "mpc")


def _run(name):
    cfg = Config().replace(**CONFIGS[name])
    jctl, jc = jro.make_rollout(cfg, dtype=jnp.float64)
    jc = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), jc)
    dq = jnp.asarray(np.random.default_rng(0).normal(scale=0.01,
                                                     size=(B, 12)))
    jc = jc._replace(sim_state=jc.sim_state._replace(
        q=jc.sim_state.q.at[:, 7:].add(dq)))
    jout = jax.jit(jax.vmap(lambda c: jro.rollout(
        jctl, c, N_TICKS, perfect_estimator=True)))(jc)
    jout = jax.tree.map(np.asarray, jout)
    tctl, _ = tro.make_rollout(TConfig(**CONFIGS[name]), device="cpu")
    tout = tro.rollout(tctl, convert.to_torch(jax.tree.map(np.asarray, jc)),
                       N_TICKS, perfect_estimator=True)
    return tout, jout


@pytest.fixture(scope="module")
def cache():
    return {}


def _cached(cache, name):
    if name not in cache:
        cache[name] = _run(name)
    return cache[name]


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request, cache):
    return request.param, _cached(cache, request.param)


def _tol(w, path):
    """`path`: a log field's name, or a carry leaf's jax keystr
    (".ctl_state.mpc.xs"), matched by whole components."""
    rel = 1e-7 if set(path.split(".")) & set(PLAN_LEAVES) else 1e-9
    return rel * max(1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("field", list(tro.RolloutLog._fields))
def test_rollout_log_parity(runs, field):
    name, ((_, tlog), (_, jlog)) = runs
    w = getattr(jlog, field)
    g = getattr(tlog, field).numpy()
    assert g.shape == w.shape == (B, N_TICKS) + w.shape[2:]
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
        if field == "error":
            assert not w.any(), "no robot may latch its security stop"
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=_tol(w, field),
                                   err_msg=f"{name} {field}")


def test_rollout_final_carry_parity(runs):
    """Every leaf of the final carry, the DDP / planner warm start
    included, converts back to qrw_tpu's classes and agrees."""
    name, ((tcarry, _), (jcarry, _)) = runs
    want_cls = {"ddp": "DDPState", "planner": "PlannerState"}[name]
    assert type(tcarry.ctl_state.mpc).__name__ == want_cls
    assert type(jcarry.ctl_state.mpc).__name__ == want_cls
    got = convert.to_numpy(tcarry, like=jcarry)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jcarry)]
    flat_g = jax.tree_util.tree_leaves(got)
    flat_w = jax.tree_util.tree_leaves(jcarry)
    assert len(flat_g) == len(flat_w) == len(paths)
    for path, g, w in zip(paths, flat_g, flat_w):
        assert g.shape == w.shape, path
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=_tol(w, path),
                                       err_msg=path)


def test_planner_drives_the_swing_feet(runs):
    """With mpc_planner the swing targets are the planner's optimized
    touchdowns (ControllerState.planner_target moves off the shoulders);
    the DDP run keeps its initial target."""
    name, ((tcarry, tlog), _) = runs
    target = tcarry.ctl_state.planner_target.numpy()
    p0 = np.broadcast_to(tro.init_state(tro.make_controller(
        TConfig()), torch.float64).planner_target.numpy(), target.shape)
    if name == "planner":
        assert np.abs(target - p0).max() > 1e-3
    else:
        np.testing.assert_array_equal(target, p0)
    assert np.isfinite(tlog.base_pos.numpy()).all()


def test_every_tick_solves_with_the_shrunken_first_node(monkeypatch):
    """mpc_every_tick: one DDP solve every tick, its first node the time
    left to the gait boundary, (k_mpc - k % k_mpc) dt_wbc, and its warm
    start shifted only on the boundary (qrw_tpu's controller.py:
    307-314), warm-started from the previous tick's solve."""
    cfg = TConfig(type_MPC=False, mpc_every_tick=True)
    calls = []
    orig = tddp.solve_mpc_ddp

    def spy(cfg_, xref, fsteps, state, *a, **k):
        res = orig(cfg_, xref, fsteps, state, *a, **k)
        calls.append((state, k, res))
        return res

    monkeypatch.setattr(tddp, "solve_mpc_ddp", spy)
    ctl, carry = tro.make_rollout(cfg, dtype=torch.float64, device="cpu")
    carry, logs = tro.rollout(ctl, carry, 3, k0=8)
    assert len(calls) == 3
    for i, (state, kw, res) in enumerate(calls):
        k = 8 + i
        want = (cfg.k_mpc - k % cfg.k_mpc) * cfg.dt_wbc
        assert float(kw["dt_first"]) == pytest.approx(want, abs=1e-15)
        assert kw["shift_warm"] is (k % cfg.k_mpc == 0)
        if i:
            assert state is calls[i - 1][2].state
    np.testing.assert_array_equal(carry.ctl_state.x_f_mpc.numpy(),
                                  calls[-1][2].x_f_applied.numpy())
    assert np.isfinite(logs.base_pos.numpy()).all()


def test_planner_and_ddp_states_convert_both_ways():
    """convert registers the DDP carries and results: a JAX
    DDPState / PlannerState goes to the port and back unchanged."""
    from qrw_tpu.core import mpc_ddp as jddp
    from qrw_tpu.core import mpc_ddp_planner as jpl
    cfg = Config()
    for init, cls in ((jddp.init_ddp_state, tddp.DDPState),
                      (jpl.init_planner_state, tpl.PlannerState)):
        j = jax.tree.map(np.asarray, init(cfg, jnp.float64))
        t = convert.to_torch(j)
        assert type(t) is cls
        back = convert.to_numpy(t, like=j)
        assert type(back) is type(j)
        for a, b in zip(back, j):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def cycles(cache):
    """4 MPC cycles of the DDP run: robot 0's cycles at k = 0, 10, 20
    and robot 1's at k = 10 (qrw_tpu's inputs)."""
    _, (_, jlog) = _cached(cache, "ddp")
    xr = np.concatenate([jlog.mpc_xref[0, ::10], jlog.mpc_xref[1, 10:11]])
    fs = np.concatenate([jlog.mpc_fsteps[0, ::10],
                         jlog.mpc_fsteps[1, 10:11]])
    return xr, fs


@pytest.mark.parametrize("fn", ["compare_solvers", "compare_solvers_warm"])
def test_compare_solvers_parity(cycles, fn):
    """eval/compare against qrw_tpu's on the same cycles: the QP plans
    to 1e-9 of scale; the DDP plans and the RMS series made from them
    to 1e-7, as above (measured: the cold 40-iteration DDP solves move
    force_rmse by 2.7e-9 N)."""
    xr, fs = cycles
    cfg = Config()
    want = jax.tree.map(np.asarray, getattr(jcmp, fn)(
        cfg, jnp.asarray(xr), jnp.asarray(fs)))
    got = getattr(tcmp, fn)(TConfig(), torch.as_tensor(xr),
                            torch.as_tensor(fs))
    for leaf, w in zip(want._fields, want):
        g = getattr(got, leaf).numpy()
        assert g.shape == w.shape, leaf
        rel = 1e-9 if leaf == "x_f_qp" else 1e-7
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * max(1.0, float(np.abs(w).max())),
            err_msg=leaf)
    s_got, s_want = tcmp.summarize(got), jcmp.summarize(want)
    assert s_got.keys() == s_want.keys() and s_got["cycles"] == 4
    for key in s_want:
        assert s_got[key] == pytest.approx(s_want[key], rel=1e-7), key


def test_capture_cycles_reads_the_rollout_log(monkeypatch):
    """capture_cycles: the logged MPC inputs at every k_mpc-th tick of
    a float64 closed-loop run (the QP backend, as Config() selects)."""
    cfg = TConfig()
    runs = []
    orig = tro.rollout
    monkeypatch.setattr(tro, "rollout",
                        lambda *a, **k: runs.append(orig(*a, **k)) or
                        runs[-1])
    xr, fs = tcmp.capture_cycles(cfg, 11, device="cpu")
    (_, logs), = runs
    assert logs.q_est.dtype == xr.dtype == torch.float64
    assert xr.shape == (2, 12, cfg.n_steps + 1)
    assert fs.shape == (2, cfg.N_gait, 12)
    np.testing.assert_array_equal(xr.numpy(), logs.mpc_xref[::10].numpy())
    np.testing.assert_array_equal(fs.numpy(), logs.mpc_fsteps[::10].numpy())


def test_compare_entry_points_cpu_and_card(monkeypatch, capsys):
    """python -m qrw_tpu_torch.eval.compare: --cpu runs qrw_tpu's run()
    on the host (here at 20 ticks); without it the capture is asked for
    on CUDA and raises on a host without a card."""
    out = tcmp.run(TConfig(), n_ticks=20, device="cpu")
    assert out["mode"] == "warm-in-loop" and out["cycles"] == 2
    assert all(np.isfinite(v) for k, v in out.items() if k != "mode")
    seen = []
    monkeypatch.setattr(tcmp, "run", lambda **k: seen.append(k) or out)
    assert tcmp.main(["--cpu"]) == out
    assert seen == [{"device": "cpu"}]
    assert '"mode": "warm-in-loop"' in capsys.readouterr().out
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcmp.main([])


def test_cli_ddp(monkeypatch, capsys):
    """--ddp runs the single-robot loop with the DDP backend (type_MPC
    False, as qrw_tpu's CLI sets it); asked for on CUDA on a host
    without a card it raises instead of running on the CPU."""
    from qrw_tpu_torch.runtime import main
    from qrw_tpu_torch.sim import rollout as ro
    seen = []
    orig = ro.make_rollout

    def spy(cfg, *a, **k):
        seen.append(cfg)
        return orig(cfg, *a, **k)

    monkeypatch.setattr(ro, "make_rollout", spy)
    assert main.main(["--ddp", "--cpu", "--ticks", "20"]) == 0
    assert len(seen) == 1 and seen[0].type_MPC is False
    assert "error=False" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main.main(["--ddp", "--ticks", "1"])


def test_cli_ddp_fleet_runs_the_phase_solver(monkeypatch):
    """qrw_tpu's fleets never read type_MPC (sim/fleet.py:103-104, 216):
    with --ddp the fleet's controller state carries a DDPState untouched
    and the fleet runs exactly as without --ddp."""
    from qrw_tpu_torch.core import mpc_lane as tml
    from qrw_tpu_torch.runtime import main
    from qrw_tpu_torch.sim import fleet as tfl

    seen = []

    class Stop(Exception):
        pass

    def fake_run_fleet(cfg, *a, **k):
        seen.append(cfg.type_MPC)
        raise Stop

    monkeypatch.setattr(main, "run_fleet", fake_run_fleet)
    with pytest.raises(Stop):
        main.main(["--fleet", "128", "--ddp", "--cpu"])
    assert seen == [False]
    monkeypatch.undo()

    cfg = TConfig()
    ps = tml.build_phase_data(cfg, tml.trot_phase_fsteps(cfg), device="cpu")
    out = {}
    for ddp in (False, True):
        c = cfg.replace(type_MPC=not ddp)
        ctl, carry = tfl.make_fleet(c, 2, ps, tile=1, device="cpu")
        carry2, logs, _ = tfl.fleet_rollout(ctl, carry, 1, ps, tile=1)
        out[ddp] = (carry, carry2, logs)
    assert isinstance(out[True][0].ctl_states.mpc, tddp.DDPState)
    assert out[True][1].ctl_states.mpc is out[True][0].ctl_states.mpc
    for a, b in zip(out[True][2], out[False][2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_analyze_compare(cache, tmp_path, capsys):
    """analyze --compare --cpu on a saved log of the port's DDP run
    re-solves its 3 MPC cycles with both backends, warm and cold; asked
    for on CUDA on a host without a card it raises."""
    from qrw_tpu_torch.utils import logger as tlogger
    (_, tlog), _ = _cached(cache, "ddp")
    one = convert.tree_map(lambda a: a[0], tlog)
    path = tlogger.save_npz(one, str(tmp_path / "run.npz"), TConfig())
    assert os.path.exists(path)
    assert tan.main([path, "--compare", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "solver comparison (warm-in-loop):" in out
    assert "solver comparison (cold):" in out and "'cycles': 3" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tan.main([path, "--compare"])
