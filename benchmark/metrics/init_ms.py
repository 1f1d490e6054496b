"""Mean ms per request in the traced run's 'init' span (host clock,
synchronized at the span's boundaries)."""

import numpy as np


def read(run):
    v = [r["spans"]["init"] for r in run.requests if "init" in r["spans"]]
    return float(np.mean(v)) * 1e3 if v else None
