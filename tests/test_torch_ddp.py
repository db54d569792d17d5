"""The DDP MPC backends against qrw_tpu: ops/ilqr, core/mpc_ddp and
core/mpc_ddp_planner.

The same problems, built with numpy from tests/test_mpc's fixtures (the
four-stance and trot footstep plans, references perturbed per problem),
go through qrw_tpu's functions (`jax.vmap` for the batched ones) and the
port's, which batch along a leading axis. One JAX compile per settings:
the cold solves pass the explicit initial state, so that the warm ones
reuse the compile.

Tolerances (float64). Near its optimum the iLQR takes steps that lower
the cost by one ulp, and whether such a step is accepted
(`cost_new < cost`) is decided by rounding: the two packages sum the
same terms in another order, so one may accept a step the other
rejects. Measured here: in the 500 Hz case below qrw_tpu accepts at
iteration 10 of the second problem a step that the port rejects
(accepted costs 0.2710273585861448 against ...485), in the cold planner
trot case the port accepts at iteration 10 what qrw_tpu rejects
(0.24580914356882588 against ...590). Such a step moves the plan by
2e-8 to 2e-7 N along a direction the cost does not see (up to 1.3e-8
of the leaf's scale). So:
  * every cost leaf (cost, cost_trace) to 1e-9 of its scale,
    max(1, |leaf|) (measured 1e-15 where no step flipped; 3e-10 on the
    planner's warm solve after the flip of its cold solve);
  * every solution leaf (x_f_applied, xs, us; the planner's fsteps,
    o_target, last_p) to 1e-9 of its scale, max(1, |leaf|) (measured
    2.3e-10 at most in the linear, nonlinear and implicit + relative
    cases), except in the two cases with a flip, the 500 Hz solves and
    the planner's (its warm solve starts from the flipped cold one):
    1e-7 there (measured 1.2e-9 and 1.3e-8);
  * ilqr.solve at 4 iterations, before the steps reach rounding, to
    1e-9 of scale on xs, us, cost and cost_trace.
ROADMAP queue 3 has the entry.

Tolerances (float32, one case, the controller's precision):
x_f_applied to 1e-3 of its scale, the cost to 1e-5 relative (measured
over a cold and a warm solve of the linear and nonlinear models: 3.0e-4
of scale, 5.0e-3 N on a first-node force; 2.2e-7 on the cost).
float32 rounding enters the Levenberg-regularized Quu (1e-9 I) and the
line search's choice between candidate costs within rounding of each
other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import hessian

from qrw_tpu.config import Config
from qrw_tpu.core import mpc_ddp as jddp
from qrw_tpu.core import mpc_ddp_planner as jpl
from qrw_tpu.ops import ilqr as jilqr
from qrw_tpu_torch import kernels
from qrw_tpu_torch.config import Config as TConfig
from qrw_tpu_torch.core import mpc_ddp as tddp
from qrw_tpu_torch.core import mpc_ddp_planner as tpl
from qrw_tpu_torch.ops import ilqr as tilqr
from tests.test_mpc import _fsteps_fourstance, _fsteps_trot, _xref, H0, MG4
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
TCFG = TConfig()
N = CFG.n_steps

XREFS = np.stack([
    _xref(),
    _xref([0.02, 0.0, H0, 0.0, 0.0, 0.0, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0]),
    _xref([0.0, 0.01, H0 - 0.01, 0.02, 0.0, 0.1, 0.0, 0.1, 0.0, 0.0, 0.0,
           0.2])])
FSTEPS = np.stack([_fsteps_fourstance(), _fsteps_trot(3), _fsteps_trot(9)])
B = XREFS.shape[0]

VARIANTS = {
    "linear": {},
    "nonlinear": {"nonlinear": True},
    "implicit_relative": {"implicit_integration": True,
                          "relative_forces": True},
}


def _scale(w):
    return max(1.0, float(np.abs(w).max()))


def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * _scale(want),
                               err_msg=what)


def _check(leaf, got, want, what, flip=False):
    """The module docstring's float64 bars: `flip` for the two cases
    where an accept decision flips."""
    _close(got, want, 1e-7 if flip and not leaf.startswith("cost")
           else 1e-9, what)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _jstate(init, cfg, dtype, batch):
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                        init(cfg, dtype))


def _ddp_pair(settings_kw, dt_first=None, shift_warm=None):
    """Cold then warm solves of the B problems in both packages."""
    js = jddp.DDPSettings(**settings_kw)
    ts = tddp.DDPSettings(**settings_kw)
    if dt_first is None:
        jfn = jax.vmap(lambda x, f, s: jddp.solve_mpc_ddp(CFG, x, f, s, js))
    else:
        jfn = jax.vmap(lambda x, f, s, d, w: jddp.solve_mpc_ddp(
            CFG, x, f, s, js, dt_first=d, shift_warm=w))
    jst = _jstate(jddp.init_ddp_state, CFG, jnp.float64, B)
    tst = None
    out = []
    for warm in (False, True):
        jargs = (jnp.asarray(XREFS), jnp.asarray(FSTEPS), jst)
        targs = dict(state=tst, settings=ts)
        if dt_first is not None:
            w = np.asarray(shift_warm) if warm else np.zeros(B, bool)
            jargs += (jnp.asarray(dt_first), jnp.asarray(w))
            targs.update(dt_first=_t(dt_first), shift_warm=torch.as_tensor(w))
        jr = jfn(*jargs)
        tr = tddp.solve_mpc_ddp(TCFG, _t(XREFS), _t(FSTEPS), **targs)
        out.append((tr, jax.tree.map(np.asarray, jr)))
        jst, tst = jr.state, tr.state
    return out


@pytest.fixture(scope="module", params=list(VARIANTS))
def ddp_runs(request):
    return request.param, _ddp_pair(VARIANTS[request.param])


@pytest.fixture(scope="module")
def ddp_dt_first_runs():
    # the 500 Hz mode: first nodes of 2, 10 and 20 ms; the warm solve
    # shifts the first problem's warm start only (a gait boundary)
    return _ddp_pair({}, dt_first=np.array([0.002, 0.01, 0.02]),
                     shift_warm=np.array([True, False, False]))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("leaf", ["x_f_applied", "cost", "cost_trace",
                                  "xs", "us"])
def test_solve_mpc_ddp_parity(ddp_runs, warm, leaf):
    name, runs = ddp_runs
    tr, jr = runs[warm]
    if leaf in ("xs", "us"):
        got, want = getattr(tr.state, leaf), getattr(jr.state, leaf)
    else:
        got, want = getattr(tr, leaf), getattr(jr, leaf)
    _check(leaf, got.numpy(), want, f"{name} {leaf}")
    np.testing.assert_array_equal(tr.iters.numpy(), jr.iters)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_solve_mpc_ddp_dt_first_parity(ddp_dt_first_runs, warm):
    tr, jr = ddp_dt_first_runs[warm]
    for leaf in ("x_f_applied", "cost", "cost_trace"):
        _check(leaf, getattr(tr, leaf).numpy(), getattr(jr, leaf), leaf,
               flip=True)
    _check("us", tr.state.us.numpy(), jr.state.us, "us", flip=True)


def test_solve_mpc_ddp_physics(ddp_runs):
    """Swing feet carry exactly zero force (the mask gates the control
    and its gains); the four-stance problem's first forces are near
    mg/4 after the warm solve."""
    _, runs = ddp_runs
    tr, _ = runs[1]
    x_f = tr.x_f_applied.numpy()
    gait = (FSTEPS[:, :N, 0::3] != 0)                      # (B, N, 4)
    forces = x_f[:, 12:, :].transpose(0, 2, 1).reshape(B, N, 4, 3)
    assert (forces[~gait] == 0.0).all()
    assert np.isfinite(x_f).all()
    np.testing.assert_allclose(forces[0, 0, :, 2], MG4, rtol=0.1)


def test_solve_mpc_ddp_float32():
    """The controller's precision: a cold and a warm solve of the
    linear model (the module docstring states the bar)."""
    jfn = jax.vmap(lambda x, f, s: jddp.solve_mpc_ddp(CFG, x, f, s))
    jst = _jstate(jddp.init_ddp_state, CFG, jnp.float32, B)
    tst = tddp.DDPState(*[_t(a, torch.float32) for a in jst])
    for _ in range(2):
        jr = jfn(jnp.asarray(XREFS, jnp.float32),
                 jnp.asarray(FSTEPS, jnp.float32), jst)
        tr = tddp.solve_mpc_ddp(TCFG, _t(XREFS, torch.float32),
                                _t(FSTEPS, torch.float32), tst)
        assert tr.x_f_applied.dtype == torch.float32
        _close(tr.x_f_applied.numpy(), np.asarray(jr.x_f_applied), 1e-3,
               "x_f_applied")
        np.testing.assert_allclose(tr.cost.numpy(), np.asarray(jr.cost),
                                   rtol=1e-5)
        jst, tst = jr.state, tr.state


def test_solve_mpc_ddp_unbatched_and_default_state():
    """One problem without a batch axis and no state equals the batched
    solve's first problem from the zero state, bit for bit."""
    one = tddp.solve_mpc_ddp(TCFG, _t(XREFS[1]), _t(FSTEPS[1]))
    both = tddp.solve_mpc_ddp(TCFG, _t(XREFS[1:]), _t(FSTEPS[1:]))
    assert one.x_f_applied.shape == (24, N) and one.cost.shape == ()
    assert one.cost_trace.shape == (10,) and one.state.us.shape == (N, 12)
    np.testing.assert_array_equal(one.x_f_applied.numpy(),
                                  both.x_f_applied[0].numpy())


def _srb_problem(k_prob=1):
    """One SRB problem as qrw_tpu's solve_mpc_ddp sets it up."""
    xref, fsteps = XREFS[k_prob], FSTEPS[k_prob]
    gait = (fsteps[:N, 0::3] != 0).astype(float)
    us0 = np.repeat(gait, 3, axis=1) * 0.0
    return xref, fsteps, gait, us0


def test_ilqr_solve_parity():
    """ops/ilqr.solve on the SRB problem against qrw_tpu's, float64,
    through the two packages' action models (the linear model, 4 iLQR
    iterations): xs, us, cost and cost_trace to 1e-9 of scale."""
    xref, fsteps, gait, us0 = _srb_problem()
    settings = jilqr.ILQRSettings(max_iters=4)
    feet = jnp.asarray(fsteps[:N])
    jg = jnp.asarray(gait)
    xref_n = jnp.asarray(xref[:, 1:].T)

    def step_k(x, u, k):
        return jddp._dynamics(CFG, x, u, feet[k], jg[k], xref_n[k, 5])

    def cost_k(x, u, k):
        return jddp._stage_cost(CFG, x, u, xref_n[k], feet[k], jg[k])

    def cost_T(x):
        return jddp._stage_cost(CFG, x, jnp.zeros(12), xref_n[-1], feet[-1],
                                jg[-1], terminal=True)

    umask = jnp.repeat(jg, 3, axis=1)
    want = jax.jit(lambda x0, u0: jilqr.solve(
        step_k, cost_k, cost_T, x0, u0, settings,
        project_u=lambda u, k: u * umask[k]))(jnp.asarray(xref[:, 0]),
                                               jnp.asarray(us0))
    want = jax.tree.map(np.asarray, want)

    c = tddp.make_consts(TCFG, torch.float64, "cpu")
    tfeet, tgait = _t(fsteps[None, :N]), _t(gait[None])
    txref = _t(xref[None, :, 1:]).transpose(1, 2)
    dt = torch.full((1, N), TCFG.dt_mpc, dtype=torch.float64)

    def step(x, u, f, g, r, d):
        return tddp._dynamics(TCFG, x, u, f, g, r[..., 5], d, c=c)

    def cost(x, u, f, g, r, d):
        return tddp._stage_cost(TCFG, x, u, r, f, g, k=c)

    def term(x, r, f, g):
        return tddp._stage_cost(TCFG, x, None, r, f, g, terminal=True, k=c)

    tmask = tddp.repeat_flags(tgait, 3)
    got = tilqr.solve(step, cost, term, _t(xref[None, :, 0]), _t(us0[None]),
                      node_args=(tfeet, tgait, txref, dt),
                      term_args=(txref[:, -1], tfeet[:, -1], tgait[:, -1]),
                      settings=tilqr.ILQRSettings(max_iters=4),
                      project_u=lambda u, k: u * tmask[:, k])
    for leaf in ("xs", "us", "cost", "cost_trace"):
        _close(getattr(got, leaf)[0].numpy(), getattr(want, leaf), 1e-9,
               leaf)
    assert float(got.cost_trace[0, -1]) < float(got.cost_trace[0, 0])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ilqr_solve_with_plain_linesearch(variant):
    """ops/ilqr.solve given its own plain line search as `linesearch`
    equals the solve with linesearch=None bit for bit, on the parity
    problems: the callable serves the initial rollout (no gains) and each
    iteration's line search, accept and cost-trace column."""
    settings = tddp.DDPSettings(**VARIANTS[variant])
    args = tddp._setup(TCFG, _t(XREFS), _t(FSTEPS), None, settings, None,
                       None)
    assert args["linesearch"] is None          # the CPU keeps the plain one
    want = tilqr.solve(**args, settings=settings.to_ilqr())
    plain = tilqr.plain_linesearch(
        args["step"], args["cost"], args["cost_T"], args["node_args"],
        args["term_args"], settings.to_ilqr(), args["project_u"])
    calls = []

    def linesearch(*a):
        calls.append(a[3] is None)
        return plain(*a)

    got = tilqr.solve(**dict(args, linesearch=linesearch),
                      settings=settings.to_ilqr())
    assert calls == [True] + [False] * settings.max_iters
    for leaf in ("xs", "us", "cost", "cost_trace"):
        assert torch.equal(getattr(got, leaf), getattr(want, leaf)), leaf


def _linesearch_call(case):
    """The line-search kernel's launcher with CPU arguments of the parity
    problems, `case` spoiling one of them."""
    settings = tddp.DDPSettings()
    f32 = torch.float32
    args = tddp._setup(TCFG, _t(XREFS, f32), _t(FSTEPS, f32), None, settings,
                       None, None)
    res = tilqr.solve(**args, settings=settings.to_ilqr()._replace(
        max_iters=1))
    kffs = [torch.zeros(B, 12) for _ in range(N)]
    Ks = [torch.zeros(B, 12, 12).transpose(1, 2) for _ in range(N)]
    call = dict(x0=args["x0"].contiguous(), xs=res.xs, us=res.us, kffs=kffs,
                Ks=Ks, cost=res.cost, reg=torch.ones(B),
                trace=torch.zeros(B, 10), it=3)
    if case == "rollout":
        call.update(xs=None, kffs=None, Ks=None, cost=None, reg=None)
    elif case == "shape":
        call["xs"] = res.xs[:, :-1].contiguous()
    elif case == "dtype":
        kffs[3] = kffs[3].double()
    elif case == "layout":
        Ks[2] = Ks[2].contiguous()
    elif case == "column":
        call["it"] = 10
    return tddp._srb_linesearch(
        tddp.derivs_params(TCFG), tddp.derivs_flags(settings),
        tddp.linesearch_params(settings),
        tuple(a.contiguous() for a in args["node_args"]),
        tuple(a.contiguous() for a in args["term_args"]), **call)


@pytest.mark.parametrize("case,error,words", [
    ("cpu", ValueError, "x0 on cpu, not CUDA"),
    ("rollout", ValueError, "x0 on cpu, not CUDA"),
    ("shape", ValueError, r"xs: shape \(3, 16, 12\), expected \(3, 17, 12\)"),
    ("dtype", TypeError, r"kffs\[3\]: dtype torch.float64, expected "
                         r"torch.float32"),
    ("layout", ValueError, r"Ks\[2\].mT: not contiguous"),
    ("column", ValueError, "column 10 of a trace of 10")])
def test_linesearch_launcher_refuses_without_loading(monkeypatch, case,
                                                     error, words):
    """The line-search kernel's launcher checks every argument (CPU
    tensors, shapes, dtypes, the gains' layout, the trace's column) and
    raises before the library is loaded."""
    def no_library():
        raise AssertionError("the launcher loaded the library")
    monkeypatch.setattr(kernels, "library", no_library)
    with pytest.raises(error, match="ddp line search kernel: " + words):
        _linesearch_call(case)


@pytest.mark.parametrize("relative_forces", [False, True])
def test_stage_cost_hessian_at_cone_tie(relative_forces):
    """At u = 0 (the cold start) every stance foot's four cone rows
    +-fx - mu_i fz, +-fy - mu_i fz sit exactly at 0: the derivative of
    max(r, 0) there is 1/2 in JAX, and the port's torch.maximum gives
    the same gradient and Hessian (torch.clamp would give 1, relu 0)."""
    xref, fsteps, gait, _ = _srb_problem(0)
    x = xref[:, 1].copy()
    x[2] += 0.01
    u = np.zeros(12)

    def jc(xu):
        return jddp._stage_cost(CFG, xu[:12], xu[12:], jnp.asarray(xref[:, 1]),
                                jnp.asarray(fsteps[0]), jnp.asarray(gait[0]),
                                relative_forces=relative_forces)

    k = tddp.make_consts(TCFG, torch.float64, "cpu")

    def tc(xu):
        return tddp._stage_cost(TCFG, xu[:12], xu[12:], _t(xref[:, 1]),
                                _t(fsteps[0]), _t(gait[0]), k,
                                relative_forces=relative_forces)

    xu = np.concatenate([x, u])
    want_h = np.asarray(jax.jit(jax.hessian(jc))(jnp.asarray(xu)))
    got_h = hessian(tc)(_t(xu)).numpy()
    want_g = np.asarray(jax.jit(jax.grad(jc))(jnp.asarray(xu)))
    got_g = torch.func.grad(tc)(_t(xu)).numpy()
    # the friction weight's 1/4 on every cone row through (fx, fz) of
    # the first foot: d2/dfx2 0.5 max(r,0)^2 = 1/4 at r = 0, twice
    assert want_h[12, 12] == pytest.approx(0.5 + 0.01 ** 2)
    np.testing.assert_allclose(got_h, want_h, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-12)


FEET0 = np.vstack([jpl.P0_SHOULDERS.reshape(4, 2).T, np.zeros((1, 4))])


@pytest.fixture(scope="module")
def planner_runs():
    """B = 2 planner solves, cold (cycle 0: lock off) and then warm at
    cycle 21 (lock on), in both packages."""
    x_fwd = _xref()
    x_fwd[6, :] = 0.5
    x_fwd[0, 1:] = 0.5 * CFG.dt_mpc * np.arange(1, N + 1)
    xrefs = np.stack([x_fwd, _xref([0.02, 0.0, H0, 0.0, 0.0, 0.0, 0.1, 0.0,
                                    0.0, 0.0, 0.0, 0.1])])
    fsteps = np.stack([_fsteps_trot(3), _fsteps_trot(10)])
    feet = np.stack([FEET0, FEET0 + 0.01])
    jfn = jax.vmap(lambda x, f, p, s, c: jpl.solve_mpc_planner(
        CFG, x, f, p, s, cycle=c))
    jst = _jstate(jpl.init_planner_state, CFG, jnp.float64, 2)
    tst = None
    out = []
    for cycle in (0, 21):
        jr = jfn(jnp.asarray(xrefs), jnp.asarray(fsteps), jnp.asarray(feet),
                 jst, jnp.full(2, cycle))
        tr = tpl.solve_mpc_planner(TCFG, _t(xrefs), _t(fsteps), _t(feet),
                                   tst, cycle=cycle)
        out.append((tr, jax.tree.map(np.asarray, jr)))
        jst, tst = jr.state, tr.state
    return fsteps, out


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm21"])
@pytest.mark.parametrize("leaf", ["x_f_applied", "fsteps", "o_target",
                                  "last_p", "cost", "cost_trace"])
def test_solve_mpc_planner_parity(planner_runs, warm, leaf):
    _, runs = planner_runs
    tr, jr = runs[warm]
    if leaf == "last_p":
        got, want = tr.state.last_p.numpy(), jr.state.last_p
    else:
        got, want = getattr(tr, leaf).numpy(), getattr(jr, leaf)
    _check(leaf, got, want, leaf, flip=True)


def test_planner_landing_mask_and_lock(planner_runs):
    """The landing mask equals qrw_tpu's; the last-position lock turns
    on after cycle 20 (the same solve at cycles 20 and 21 differs)."""
    fsteps, runs = planner_runs
    gait = (fsteps[:, :N, 0::3] != 0).astype(float)
    want = np.asarray(jax.vmap(jpl.landing_mask)(jnp.asarray(gait),
                                                 jnp.asarray(gait[:, 0])))
    got = tpl.landing_mask(_t(gait), _t(gait[:, 0])).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any()
    tr_cold, _ = runs[0]
    args = (TCFG, _t(np.stack([_xref(), _xref()])), _t(fsteps),
            _t(np.stack([FEET0, FEET0])), tr_cold.state)
    unlocked = tpl.solve_mpc_planner(*args, cycle=20)
    locked = tpl.solve_mpc_planner(*args, cycle=21)
    assert (locked.cost != unlocked.cost).all()
    assert np.isfinite(locked.x_f_applied.numpy()).all()
