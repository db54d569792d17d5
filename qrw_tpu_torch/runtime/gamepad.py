"""Host gamepad reader feeding the controller's command channel.

Port of qrw_tpu/runtime/gamepad.py (the reference's gamepad client,
scripts/gamepadClient.py:16-88). A background process polls the gamepad
and publishes the latest (axes, buttons) frame into a seqlock
shared-memory mailbox (runtime/ipc.Mailbox); the control loop reads the
freshest frame wait-free. The analog scaling and low-pass into a 6-dof
velocity command is core/joystick.gamepad_update.

The evdev dependency (the `inputs` package) is imported lazily, in the
reader only: without it or a physical gamepad, `GamepadReader` takes
any callable event source; `SyntheticGamepad` plays a scripted table.

The reader process is started with the spawn method. The control loop's
process may already hold a CUDA context and torch's thread pools; a
forked child would inherit both, and neither is safe to use after a
fork. A spawned child starts from a fresh interpreter: it touches only
the mailbox and the event source, never the card.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from typing import Callable, Optional

import numpy as np

# frame layout: [lx, ly, rx, ry, btn_start, btn_back, btn_L1,
#                btn_gait0, btn_gait1, btn_gait2, btn_gait3]
FRAME_SIZE = 11

_CTX = mp.get_context("spawn")


def _read_evdev_frame(state: np.ndarray) -> np.ndarray:  # pragma: no cover
    """Poll one batch of evdev events into the frame (blocking).

    Mirrors the event decoding of scripts/gamepadClient.py:50-88."""
    from inputs import get_gamepad
    events = get_gamepad()
    for e in events:
        if e.code == "ABS_X":
            state[0] = e.state / 32768.0
        elif e.code == "ABS_Y":
            state[1] = e.state / 32768.0
        elif e.code == "ABS_RX":
            state[2] = e.state / 32768.0
        elif e.code == "ABS_RY":
            state[3] = e.state / 32768.0
        elif e.code == "BTN_START":
            state[4] = e.state
        elif e.code == "BTN_SELECT":
            state[5] = e.state
        elif e.code == "BTN_TL":
            state[6] = e.state
        elif e.code in ("BTN_SOUTH", "BTN_EAST", "BTN_NORTH", "BTN_WEST"):
            idx = {"BTN_SOUTH": 7, "BTN_EAST": 8,
                   "BTN_NORTH": 9, "BTN_WEST": 10}[e.code]
            state[idx] = e.state
    return state


def _reader_main(mailbox_name: str, source: Optional[Callable],
                 period_s: float, stop_flag):
    from qrw_tpu_torch.runtime.ipc import Mailbox
    box = Mailbox(mailbox_name, (FRAME_SIZE,), create=False)
    state = np.zeros(FRAME_SIZE)
    read = source if source is not None else _read_evdev_frame
    try:
        while not stop_flag.value:
            state = np.asarray(read(state), dtype=np.float64)
            box.write(state)
            if period_s > 0:
                time.sleep(period_s)
    finally:
        box.close()


class GamepadReader:
    """Background gamepad publisher + wait-free consumer.

    source: optional callable(state) -> state replacing the evdev poll
    (synthetic input, replayed input, tests); it is pickled to the
    spawned reader. The consumer side (`read()`) never blocks: it
    returns the freshest published frame (zeros until the reader's
    first one), like the shared Values of the reference client. A
    source that raises ends the reader with its traceback on stderr;
    `read()` then keeps returning the last frame."""

    def __init__(self, source: Optional[Callable] = None,
                 period_s: float = 0.002, name: Optional[str] = None):
        from qrw_tpu_torch.runtime.ipc import Mailbox
        self.name = name or f"/qrw_gamepad_{os.getpid()}_{id(self):x}"
        self._box = Mailbox(self.name, (FRAME_SIZE,), create=True)
        self._box.write(np.zeros(FRAME_SIZE))
        self._stop = _CTX.Value("b", False)
        # the spawned child unpickles the source's shared counter later:
        # it must outlive this call
        self._source = source
        self._proc = _CTX.Process(
            target=_reader_main,
            args=(self.name, source, period_s, self._stop), daemon=True)
        self._proc.start()
        self._last = np.zeros(FRAME_SIZE)

    def read(self) -> np.ndarray:
        """Freshest (FRAME_SIZE,) frame (never blocks)."""
        frame = self._box.read()
        if frame is not None:
            self._last = np.asarray(frame)
        return self._last

    @property
    def axes(self) -> np.ndarray:
        return self.read()[0:4]

    @property
    def buttons(self) -> np.ndarray:
        return self.read()[4:]

    def stop(self):
        self._stop.value = True
        self._proc.join(timeout=10.0)
        if self._proc.is_alive():  # pragma: no cover
            self._proc.terminate()
            self._proc.join(timeout=5.0)
        self._box.close()


class SyntheticGamepad:
    """Scripted event source: a (T, FRAME_SIZE) table played back one
    row per poll (wraps around). Stands in for a physical gamepad."""

    def __init__(self, frames: np.ndarray):
        self.frames = np.atleast_2d(np.asarray(frames, dtype=np.float64))
        self._k = _CTX.Value("i", 0)

    def __call__(self, state: np.ndarray) -> np.ndarray:
        with self._k.get_lock():
            k = self._k.value
            self._k.value = k + 1
        return self.frames[k % len(self.frames)]
