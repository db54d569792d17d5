"""Milliseconds a cycle that the host spends in the port's blocking
reads of the card: the union of its `qrw.sync.*` spans (utils/profiling.
host_read: explicit reads, library calls that read a status back,
copies from pageable host memory). A lower bound while the benchmark's
wrappers synchronize at both ends of each layer: a read soon after a
wrapper's entry finds the card idle and returns at once."""

from qrwbench.trace import union_seconds


def read(tr):
    iv = [i for name, ivs in tr.spans.items()
          if name.startswith("qrw.sync.") for i in ivs]
    if not iv:
        return None
    return 1e3 * union_seconds(iv) / tr.cycles
