"""One thread for every CPU math library of a test process.

The port's test files call `single_thread()` where they are imported.
pytest-xdist's workers import every test file, so it holds for the whole
process, JAX's tests included. torch's own pool is limited by
torch.set_num_threads; numpy's BLAS (OpenBLAS, 8 threads by default)
through threadpoolctl. The tests' matrices are small, and with the
workers' XLA thread pools busy on the same cores, a threaded BLAS call
waits on its own threads: measured on an 8-core host with a JAX fleet
test in parallel, core/mpc_lane.build_phase_data at a 232-phase set took
7-32 s with 8 BLAS threads and 1.1-1.4 s with one (1.1-1.5 s with 8
threads on an idle host)."""

import torch


def single_thread():
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:         # no threadpoolctl: numpy keeps its pool
        return
    threadpool_limits(1, user_api="blas")
