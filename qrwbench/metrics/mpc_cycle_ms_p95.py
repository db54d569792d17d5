"""The 95th percentile of the MPC cycles' times, in ms, over the untraced
cycles of a traced run's window: each cycle from an event recorded on the
card's stream before its first operation to one after its last (the
stream idle before it, since every cycle ends in a synchronize), so a
cycle is timed by the card's clock."""

import statistics


def p95(values):
    values = sorted(values)
    if len(values) < 2:
        return values[0] if values else None
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def read(tr):
    if tr.window is None:
        return None
    return p95([c["device_ms"] for c in tr.window.cycles if "device_ms" in c])
