"""The port's host runtime against qrw_tpu's: IPC mailboxes and pacer,
the joystick's gamepad and table modes, the device facade, the host
loop and its pipelined variant, the MPC service, the gamepad reader,
replay, and the CLI's host-loop mode.

Both packages run in float64 from the same inputs. Tolerances:
  * the joystick: 1e-12 (the same arithmetic, in numpy and torch);
  * the device facade and replay: the simulator's float64 bar of
    tests/test_torch_physics.py, 1e-9 of each quantity's scale, over
    tens of ticks; replaying the port's own log: 1e-10 absolute (the
    JAX package's test_aux bar);
  * the host loops: the rollout parity bar of
    tests/test_torch_rollout.py, 1e-9 of scale;
  * the MPC service: its worker's plan equals the port's direct
    solve_mpc to 1e-12 of scale (the worker runs torch's default thread
    count, the test one thread: the products sum in another order;
    measured 1.9e-12 absolute on forces of ~6 N), and qrw_tpu's
    solve_mpc to 1e-8 of scale (the float64 bar of
    tests/test_torch_controller.py); its warm second solve, started
    from a warm state that differs by that rounding, the direct warm
    solve to 1e-9 of scale (measured 2.6e-10 absolute).
Mailbox and gamepad names carry the pid and an id, and every mailbox is
closed in `finally`, so nothing is left in /dev/shm. The pacer's bound
is loose: six test workers load the host."""

import multiprocessing as mp
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrw_tpu.config import Config
from qrw_tpu.core import joystick as jjoy
from qrw_tpu.runtime import host_loop as jhl
from qrw_tpu.runtime import ipc as jipc
from qrw_tpu.runtime import replay as jrep
from qrw_tpu.sim import device as jdev
from qrw_tpu.sim import rollout as jro
from qrw_tpu.utils import logger as jlog
from qrw_tpu_torch.core import joystick as tjoy
from qrw_tpu_torch.runtime import host_loop as thl
from qrw_tpu_torch.runtime import ipc as tipc
from qrw_tpu_torch.runtime import replay as trep
from qrw_tpu_torch.sim import device as tdev
from qrw_tpu_torch.sim import rollout as tro
from tests import torch_children
from tests.torch_threads import single_thread

single_thread()

CFG = Config()
F64 = torch.float64
N_TICKS = 40
HOLD_TICKS = 50
FORCE = np.array([6.0, -4.0, 0.0])
SPAWN = mp.get_context("spawn")


@pytest.fixture
def single_threaded_children(monkeypatch):
    """A child spawned in the test starts with one OpenMP and one
    OpenBLAS thread, as single_thread() leaves this process: with the
    other test workers busy, a child with the default pools can take
    many times longer over its first solves."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("OPENBLAS_NUM_THREADS", "1")


def _name(tag):
    return f"/qrwt_{tag}_{os.getpid()}_{time.monotonic_ns():x}"


def _scale_tol(w, rel):
    return rel * max(1.0, float(np.abs(w).max()))


def _close(got, want, rel, msg=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_scale_tol(want, rel), err_msg=msg)


# ----------------------------------------------------------------------
# IPC
# ----------------------------------------------------------------------

def test_ipc_library_builds_from_the_ports_source():
    """The library is built from qrw_tpu_torch/csrc/qrw_ipc.cpp into
    qrw_tpu_torch/_build/, never from or into native/."""
    tipc.load_library()
    so = tipc._build_lib()
    assert os.path.dirname(so) == tipc.BUILD_DIR
    assert tipc.SOURCE.endswith(os.path.join("qrw_tpu_torch", "csrc",
                                             "qrw_ipc.cpp"))


def test_mailbox_round_trip_and_sequence():
    box = tipc.Mailbox(_name("rt"), (4, 3))
    try:
        assert box.read() is None and box.seq == 0   # nothing published
        a = np.arange(12.0).reshape(4, 3)
        assert box.write(a) == 2                      # even: stable
        np.testing.assert_array_equal(box.read(), a)
        assert box.read() is None                     # no new data
        box.write(a * 2)
        assert box.write(a * 3) == 6                  # a missed update
        np.testing.assert_array_equal(box.read(), a * 3)   # latest wins
        assert box.seq == 6
        with pytest.raises(ValueError):
            box.write(np.zeros(3))
    finally:
        box.close()


def test_mailbox_across_a_spawned_process(single_threaded_children):
    name = _name("xp")
    box = tipc.Mailbox(name, (8,))
    try:
        p = SPAWN.Process(target=torch_children.ipc_writer, args=(name,))
        p.start()
        seen = []
        t0 = time.time()
        while time.time() - t0 < 60 and (not seen or seen[-1] != 4.0):
            got = box.read()
            if got is not None:
                seen.append(float(got[0]))
            time.sleep(0.001)
        p.join(timeout=30)
        assert not p.is_alive() and p.exitcode == 0
        assert seen and seen[-1] == 4.0
        assert seen == sorted(seen)             # monotone, no reordering
    finally:
        box.close()


def test_port_mailbox_reads_the_jax_packages():
    """Same layout, same source: each package reads what the other
    wrote under the same name."""
    name = _name("jx")
    jbox = jipc.Mailbox(name, (2, 5))
    tbox = tipc.Mailbox(name, (2, 5), create=False)
    try:
        a = np.linspace(-1.0, 1.0, 10).reshape(2, 5)
        jbox.write(a)
        np.testing.assert_array_equal(tbox.read(), a)
        tbox.write(-a)
        np.testing.assert_array_equal(jbox.read(), -a)
        assert tbox.seq == jbox.seq == 4
    finally:
        tbox.close()
        jbox.close()


def test_pacer_period():
    p = tipc.Pacer(0.002, spin_s=50e-6)          # the 500 Hz budget
    try:
        t0 = time.perf_counter()
        lates = [p.wait() for _ in range(50)]
        dt = time.perf_counter() - t0
        assert 0.095 < dt < 0.3, dt              # ~50 periods of 2 ms
        assert np.median(lates) < 2e-3           # loose: a loaded host
        assert p.overruns <= 50
    finally:
        p.close()


# ----------------------------------------------------------------------
# Joystick: the table modes and the gamepad filter
# ----------------------------------------------------------------------

def test_joystick_modes_parity():
    for k in (0, 479, 480, 700, 2980, 3480, 100000):
        for v in ((0.5, -0.2, 0.4), (0.0, 1.3, -0.05)):
            np.testing.assert_allclose(
                tjoy.v_ref_multi_simu(k, *v, CFG.k_mpc).numpy(),
                np.asarray(jjoy.v_ref_multi_simu(k, *v, CFG.k_mpc)),
                rtol=0, atol=1e-12)
    des = np.array([0.9, -0.1, 0.0, 0.0, 0.0, 0.3])
    tk, tv = tjoy.analysis_tables(des, 1500, 800)
    jk, jv = jjoy.analysis_tables(des, 1500, 800)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tv, jv)
    for k in (0, 200, 500, 777, 1000, 1499, 1500, 2299, 2300, 5000):
        np.testing.assert_allclose(
            tjoy.v_ref_from_tables(k, tk, tv).numpy(),
            np.asarray(jjoy.v_ref_from_tables(k, jk, jv)), rtol=0,
            atol=1e-12)


@pytest.mark.parametrize("orientation", [False, True])
def test_gamepad_update_sequence_parity(orientation):
    """50 filter steps on seeded axes and buttons: v_ref and the gait
    code after every step."""
    rng = np.random.default_rng(3)
    axes = rng.uniform(-1.0, 1.0, size=(50, 4))
    buttons = (rng.random((50, 4)) < 0.15).astype(np.float64)
    ts = tjoy.init_gamepad_state(F64)
    js = jjoy.init_gamepad_state(jnp.float64)
    for a, b in zip(axes, buttons):
        ts = tjoy.gamepad_update(CFG, ts, a, b, orientation)
        js = jjoy.gamepad_update(CFG, js, jnp.asarray(a), jnp.asarray(b),
                                 orientation)
        np.testing.assert_allclose(ts.v_ref.numpy(), np.asarray(js.v_ref),
                                   rtol=0, atol=1e-12)
        assert int(ts.gait_code) == int(js.gait_code)
        assert ts.gait_code.dtype == torch.int32


# ----------------------------------------------------------------------
# The device facade
# ----------------------------------------------------------------------

def _hold_and_push(dev):
    """PD hold of q_init for HOLD_TICKS, then FORCE on the base for 10
    ticks: (q_mes, dummyPos) per tick."""
    dev.Init(q_init=CFG.q_init)
    dev.SetDesiredJointPDgains(np.full(12, 6.0), np.full(12, 0.3))
    dev.SetDesiredJointPosition(np.asarray(CFG.q_init))
    dev.SetDesiredJointVelocity(np.zeros(12))
    dev.SetDesiredJointTorque(np.zeros(12))
    q, pos = [], []
    for t in range(HOLD_TICKS + 10):
        if t == HOLD_TICKS:
            dev.ApplyExternalForce(FORCE)
        dev.UpdateMeasurment()
        dev.SendCommand(WaitEndOfCycle=False)
        dev.UpdateMeasurment()
        q.append(np.array(dev.q_mes))
        pos.append(np.array(dev.dummyPos))
    return np.stack(q), np.stack(pos)


@pytest.fixture(scope="module")
def device_runs():
    want = _hold_and_push(jdev.SimDevice(CFG, dtype=jnp.float64))
    got = _hold_and_push(tdev.SimDevice(CFG, dtype=F64, device="cpu"))
    return got, want


def test_device_pd_hold_parity(device_runs):
    (tq, tpos), (jq, jpos) = device_runs
    n = HOLD_TICKS
    _close(tq[:n], jq[:n], 1e-9, "q_mes")
    _close(tpos[:n], jpos[:n], 1e-9, "dummyPos")
    assert abs(tpos[n - 1, 2] - 0.24) < 0.05      # settled, not fallen


def test_apply_external_force_parity(device_runs):
    (tq, tpos), (jq, jpos) = device_runs
    n = HOLD_TICKS
    _close(tq[n:], jq[n:], 1e-9, "q_mes")
    _close(tpos[n:], jpos[n:], 1e-9, "dummyPos")
    # the push moved the base along +x, -y
    assert tpos[-1, 0] - tpos[n - 1, 0] > 1e-5
    assert tpos[-1, 1] - tpos[n - 1, 1] < -1e-5


def test_put_on_the_floor_parity():
    jd = jdev.SimDevice(CFG, dtype=jnp.float64)
    jd.Init(q_init=CFG.q_init)
    want = jdev.put_on_the_floor(jd, CFG.q_init, duration_s=0.2)
    td = tdev.SimDevice(CFG, dtype=F64, device="cpu")
    td.Init(q_init=CFG.q_init)
    got = tdev.put_on_the_floor(td, CFG.q_init, duration_s=0.2)
    assert got < 0.15                    # the startup-abort threshold
    assert abs(got - want) < 1e-9
    _close(td.q_mes, np.asarray(jd.q_mes), 1e-9)


def test_dummy_device_parity():
    j = jdev.DummyDevice(CFG, dtype=jnp.float64)
    t = tdev.DummyDevice(CFG, dtype=F64, device="cpu")
    for f in j.device_data._fields:
        np.testing.assert_array_equal(
            getattr(t.device_data, f).numpy(),
            np.asarray(getattr(j.device_data, f)), err_msg=f)
    for attr in ("baseLinearAcceleration", "baseAngularVelocity",
                 "baseOrientation", "q_mes", "v_mes", "dummyPos",
                 "b_baseVel"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr),
                                      err_msg=attr)


def test_mixed_devices_raise():
    """A loop whose clone differs from its device in dtype raises; on a
    host without a card a device asked for on CUDA raises instead of
    running on the CPU."""
    dev = tdev.SimDevice(CFG, dtype=F64, device="cpu")
    dev.Init(q_init=CFG.q_init)
    clone = tdev.SimDevice(CFG, dtype=torch.float32, device="cpu")
    clone.Init(q_init=CFG.q_init)
    with pytest.raises(ValueError, match="dtype|float"):
        thl.run_host_loop(CFG, n_ticks=2, device=dev, clone=clone,
                          dtype=F64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdev.SimDevice(CFG)
        with pytest.raises(RuntimeError, match="CUDA"):
            thl.run_host_loop(CFG, n_ticks=1)


# ----------------------------------------------------------------------
# The host loops
# ----------------------------------------------------------------------

def test_host_loop_parity():
    want = jhl.run_host_loop(CFG, n_ticks=N_TICKS, dtype=jnp.float64)
    got = thl.run_host_loop(CFG, n_ticks=N_TICKS, dtype=F64,
                            torch_device="cpu")
    assert got.n_ticks == want.n_ticks == N_TICKS
    assert (got.error, got.startup_abort, got.timeout) == (False,) * 3
    _close(got.q_log, want.q_log, 1e-9, "q_log")
    _close(got.tau_log, want.tau_log, 1e-9, "tau_log")
    assert np.all(np.abs(got.q_log[:, 2] - CFG.h_ref) < 0.06)


def test_host_loop_startup_abort():
    """A device whose joints are far from the controller's first command
    aborts on tick 0, in both packages."""
    q_far = np.asarray(CFG.q_init) + 0.8
    jd = jdev.SimDevice(CFG, dtype=jnp.float64)
    jd.Init(q_init=q_far)
    want = jhl.run_host_loop(CFG, n_ticks=10, device=jd, dtype=jnp.float64)
    td = tdev.SimDevice(CFG, dtype=F64, device="cpu")
    td.Init(q_init=q_far)
    got = thl.run_host_loop(CFG, n_ticks=10, device=td, dtype=F64)
    assert want.startup_abort and want.n_ticks == 1
    assert got.startup_abort and got.n_ticks == 1


def test_host_loop_pipelined_parity():
    want = jhl.run_host_loop_pipelined(CFG, n_ticks=N_TICKS, depth=2,
                                       dtype=jnp.float64)
    got = thl.run_host_loop_pipelined(CFG, n_ticks=N_TICKS, depth=2,
                                      dtype=F64, torch_device="cpu")
    assert got.n_ticks == want.n_ticks == N_TICKS and not got.error
    _close(got.q_log, want.q_log, 1e-9, "q_log")
    assert got.periods_ms.shape == (N_TICKS - 1,)
    assert (got.periods_ms > 0).all() and np.isfinite(got.periods_ms).all()


def test_damping_shutdown_parity():
    jd = jdev.SimDevice(CFG, dtype=jnp.float64)
    jd.Init(q_init=CFG.q_init)
    jhl._damping_shutdown(jd, CFG, duration_s=0.05)
    jd.UpdateMeasurment()
    td = tdev.SimDevice(CFG, dtype=F64, device="cpu")
    td.Init(q_init=CFG.q_init)
    thl._damping_shutdown(td, CFG, duration_s=0.05)
    td.UpdateMeasurment()
    _close(td.q_mes, np.asarray(jd.q_mes), 1e-9)
    np.testing.assert_array_equal(td.P, 0.0)
    np.testing.assert_array_equal(td.D, 0.0)


# ----------------------------------------------------------------------
# The gamepad reader and the clone
# ----------------------------------------------------------------------

def test_gamepad_reader_publishes_frames(single_threaded_children):
    from qrw_tpu_torch.runtime.gamepad import (FRAME_SIZE, GamepadReader,
                                               SyntheticGamepad)
    frames = np.zeros((4, FRAME_SIZE))
    frames[:, 0] = [0.1, 0.2, 0.3, 0.4]       # left-stick x ramp
    frames[:, 7] = [0, 0, 1, 1]               # gait button 0 pressed late
    gp = GamepadReader(source=SyntheticGamepad(frames), period_s=0.001,
                       name=_name("gp"))
    try:
        deadline = time.time() + 60.0        # a spawned child: start-up
        got = None
        while time.time() < deadline:
            f = gp.read()
            if f[0] > 0:
                got = f
                break
            time.sleep(0.005)
        assert got is not None, "no frame published"
        assert got[0] in frames[:, 0]
        assert gp.axes.shape == (4,) and gp.buttons.shape == (7,)
    finally:
        gp.stop()
    assert not gp._proc.is_alive()


def test_host_loop_with_gamepad_and_clone(single_threaded_children):
    """The gamepad drives the command (a held stick), the clone gets the
    same commands: its joints equal the primary's."""
    from qrw_tpu_torch.runtime.gamepad import (FRAME_SIZE, GamepadReader,
                                               SyntheticGamepad)
    frames = np.zeros((1, FRAME_SIZE))
    frames[0, 0] = 0.5                         # push the stick forward
    gp = GamepadReader(source=SyntheticGamepad(frames), period_s=0.001,
                       name=_name("gpc"))
    clone = tdev.SimDevice(CFG, dtype=F64, device="cpu")
    clone.Init(q_init=CFG.q_init)
    try:
        t0 = time.time()
        while gp.read()[0] == 0 and time.time() - t0 < 60:
            time.sleep(0.005)
        res = thl.run_host_loop(CFG, n_ticks=N_TICKS, gamepad=gp,
                                clone=clone, dtype=F64, torch_device="cpu")
    finally:
        gp.stop()
    assert not res.startup_abort and not res.error
    clone.UpdateMeasurment()
    np.testing.assert_allclose(clone.q_mes, res.q_log[-1, 7:], rtol=0,
                               atol=1e-12)
    # the filtered stick command moves the robot forward
    assert res.q_log[-1, 0] > res.q_log[0, 0]


# ----------------------------------------------------------------------
# The MPC service
# ----------------------------------------------------------------------

def _mpc_problem():
    rng = np.random.default_rng(5)
    xref = np.zeros((12, CFG.n_steps + 1))
    xref[2, :] = 0.2447
    xref[:, 0] += rng.normal(scale=0.01, size=12)
    xref[6, 1:] = 0.3
    feet = np.array([0.195, 0.147, 0.0, 0.195, -0.147, 0.0,
                     -0.195, 0.147, 0.0, -0.195, -0.147, 0.0])
    fsteps = np.zeros((CFG.N_gait, 12))
    fsteps[:CFG.n_steps] = feet
    return xref, fsteps


def test_mpc_service_matches_direct_solve(single_threaded_children):
    """One spawned worker on the CPU: its plan against the port's direct
    solve and qrw_tpu's; the stale read; the warm second solve; stop."""
    from qrw_tpu.core import mpc as jmpc
    from qrw_tpu_torch.core import mpc as tmpc
    from qrw_tpu_torch.runtime.mpc_service import MPCService

    xref, fsteps = _mpc_problem()
    svc = MPCService(CFG, name=_name("mpc")[1:], device="cpu")
    try:
        svc.solve(0, xref, fsteps)
        got = svc.wait_result()
        assert svc.startup_s is not None and svc.startup_s > 0
        st = tmpc.init_mpc_state(CFG, F64)
        direct = tmpc.solve_mpc(CFG, torch.as_tensor(xref),
                                torch.as_tensor(fsteps), st)
        _close(got, direct.x_f_applied.numpy(), 1e-12)
        want = np.asarray(jmpc.solve_mpc(
            CFG, jnp.asarray(xref), jnp.asarray(fsteps),
            jmpc.init_mpc_state(CFG, jnp.float64)).x_f_applied)
        _close(got, want, 1e-8)
        # nothing new: the stale plan
        np.testing.assert_array_equal(svc.get_latest_result(), got)
        # the worker warm-starts from its previous solve
        xref2 = xref.copy()
        xref2[0, 0] += 0.001
        svc.solve(1, xref2, fsteps)
        got2 = svc.wait_result()
        warm = tmpc.solve_mpc(CFG, torch.as_tensor(xref2),
                              torch.as_tensor(fsteps), direct.state)
        _close(got2, warm.x_f_applied.numpy(), 1e-9)
    finally:
        svc.stop()
    assert not svc._proc.is_alive() and svc._proc.exitcode == 0


# ----------------------------------------------------------------------
# Replay
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def logged_run(tmp_path_factory):
    """A port rollout (float64, zero command) saved by qrw_tpu's
    save_npz: the port replays a file the JAX package wrote."""
    ctl, carry = tro.make_rollout(CFG, dtype=F64, device="cpu")
    _, logs = tro.rollout(ctl, carry, N_TICKS,
                          v_ref_schedule=np.zeros((N_TICKS, 6)))
    as_jax = jro.RolloutLog(**{f: getattr(logs, f).numpy()
                               for f in logs._fields})
    path = jlog.save_npz(as_jax, str(tmp_path_factory.mktemp("rp")
                                     / "run.npz"), CFG)
    return logs, path


def test_replay_reproduces_the_ports_rollout(logged_run):
    logs, path = logged_run
    _, rlog = trep.replay_from_npz(path, CFG, dtype=F64, device="cpu")
    assert isinstance(rlog, trep.ReplayLog)
    np.testing.assert_allclose(rlog.base_pos.numpy(), logs.base_pos.numpy(),
                               rtol=0, atol=1e-10)


def test_replay_from_a_jax_npz_parity(logged_run):
    _, path = logged_run
    jss, jlogs = jrep.replay_from_npz(path, CFG, dtype=jnp.float64)
    tss, tlogs = trep.replay_from_npz(path, CFG, dtype=F64, device="cpu")
    for f in trep.ReplayLog._fields:
        _close(getattr(tlogs, f).numpy(), np.asarray(getattr(jlogs, f)),
               1e-9, f)
    _close(tss.q.numpy(), np.asarray(jss.q), 1e-9, "q")


# ----------------------------------------------------------------------
# The CLI's host-loop mode
# ----------------------------------------------------------------------

def test_cli_host_loop_clone(capsys):
    """--host-loop --clone on the CPU in float64: qrw_tpu's two summary
    lines, exit 0 (20 ticks, then the 2.5 s damping shutdown)."""
    from qrw_tpu_torch.runtime import main
    rc = main.main(["--host-loop", "--clone", "--cpu", "--f64",
                    "--ticks", "20"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out[0] == ("host loop: 20 ticks, startup_abort=False, "
                      "error=False, timeout=False")
    assert out[1].startswith("final pos [0.000 0.000 0.24")
    assert "max |tau_ff|" in out[1]


def test_cli_host_loop_flags(monkeypatch, capsys):
    """--gamepad, --realtime and --clone reach run_host_loop (a fake
    here), --gamepad through a GamepadReader that is stopped after the
    run; an abort returns 1."""
    from qrw_tpu_torch.runtime import gamepad, main
    seen = {}

    class FakeReader:
        def __init__(self):
            seen["reader"] = self

        def stop(self):
            seen["stopped"] = True

    def fake_run(cfg, n_ticks, clone, gamepad, realtime, shutdown, gait,
                 dtype, torch_device):
        seen.update(n_ticks=n_ticks, clone=clone, gamepad=gamepad,
                    realtime=realtime, shutdown=shutdown, device=torch_device)
        return thl.HostLoopResult(1, False, True, False, np.zeros((1, 19)),
                                  np.zeros((1, 12)))

    monkeypatch.setattr(gamepad, "GamepadReader", FakeReader)
    monkeypatch.setattr(thl, "run_host_loop", fake_run)
    rc = main.main(["--host-loop", "--gamepad", "--realtime", "--cpu",
                    "--ticks", "7"])
    assert rc == 1                      # the (fake) startup abort
    assert seen["gamepad"] is seen["reader"] and seen["stopped"]
    assert seen["realtime"] and seen["shutdown"] and seen["clone"] is None
    assert (seen["n_ticks"], seen["device"]) == (7, "cpu")
    assert "startup_abort=True" in capsys.readouterr().out


def test_cli_fleets_take_batch_bumpy_envid(monkeypatch):
    """--batch, --bumpy and --envID with --fleet / --hetero no longer
    exit 2: the fleets run, as qrw_tpu's entry point runs them, without
    reading them (the flags only reach the config)."""
    from qrw_tpu_torch.runtime import main
    seen = []

    class Stop(Exception):
        pass

    def fake(cfg, batch, *a, **k):
        seen.append((batch, cfg.use_flat_plane, cfg.envID))
        raise Stop

    monkeypatch.setattr(main, "run_fleet", fake)
    monkeypatch.setattr(main, "run_hetero", fake)
    for argv, want in [(["--fleet", "128", "--bumpy"], (128, False, 0)),
                       (["--fleet", "256", "--envID", "1"], (256, True, 1)),
                       (["--hetero", "384", "--batch", "2"],
                        (384, True, 0))]:
        with pytest.raises(Stop):
            main.main(argv)
        assert seen.pop() == want, argv
