"""The share of the traced stretch (the first traced request's start to the
last one's end) in which no kernel, copy or memset ran on the card, %."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
