"""device.idle_pct: the share of the profiled stretch, in per cent, in
which no kernel, copy or fill ran on the card."""

from benchmark.tracing import busy_s


def read(run):
    t = run.take
    if t is None or not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(t) / t.window_s)
