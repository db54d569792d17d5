"""No run loads JAX or the JAX package, and the references load nothing
of the port. Each check runs in a fresh interpreter."""

import json
import subprocess
import sys

from qrwbench import harness
from qrwbench.run import forbidden_modules


def fresh(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_whole_top_level_names():
    mods = ["qrw_tpu_torch", "qrw_tpu_torch.sim.fleet", "jaxtyping",
            "qrw_tpu", "qrw_tpu.core.mpc", "jax.numpy", "flax", "jaxlib"]
    assert forbidden_modules(mods) == ["flax", "jax.numpy", "jaxlib",
                                       "qrw_tpu", "qrw_tpu.core.mpc"]


def test_a_run_of_every_cell_loads_no_jax():
    got = fresh(
        "import json, sys, time\n"
        "from qrwbench.tests.helpers import TINY, run_tiny\n"
        "from qrwbench.run import forbidden_modules\n"
        "for name in sorted(TINY):\n"
        "    run_tiny(name, seconds=0.1)\n"
        "print(json.dumps({'bad': forbidden_modules(),\n"
        "    'port': 'qrw_tpu_torch' in sys.modules}))\n")
    assert got == {"bad": [], "port": True}


def test_the_references_load_nothing_of_the_port():
    got = fresh(
        "import json, sys\n"
        "import qrwbench.reference.mpc_qp, qrwbench.reference.robot\n"
        "import qrwbench.reference.terrain\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('qrw_tpu_torch', 'qrw_tpu', 'jax',\n"
        "                           'jaxlib', 'flax'))))\n")
    assert got == []
