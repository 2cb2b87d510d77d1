"""The 95th percentile of every request's latency in the window (ms): from
the request's start, its clouds' prepare included, to its pose on the
host."""

import numpy as np


def read(run):
    lat = [r.latency_s for r in run.records if np.isfinite(r.latency_s)]
    if not lat:
        return None
    return float(np.percentile(lat, 95.0)) * 1e3
