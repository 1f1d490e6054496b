"""The 95th percentile of all the window's solve latencies (host clock from
the request's start until its trajectory is on the host), in ms."""

import numpy as np


def read(run):
    return float(np.percentile([r["latency_s"] for r in run.requests], 95)) * 1e3
