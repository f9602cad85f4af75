"""p50_ms: the median latency of every query of the window, from send to
reply; a query in a batch has its batch's latency."""

import numpy as np


def read(run):
    lat = run.window.query_latencies_ms()
    return float(np.percentile(lat, 50)) if lat.size else None
