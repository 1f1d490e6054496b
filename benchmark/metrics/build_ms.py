"""Mean ms per request in the traced run's 'build' span (host clock,
synchronized at the span's boundaries)."""

import numpy as np


def read(run):
    v = [r["spans"]["build"] for r in run.requests if "build" in r["spans"]]
    return float(np.mean(v)) * 1e3 if v else None
