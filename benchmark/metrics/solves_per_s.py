"""Solves completed in the window over its length; the window ends when the
first solve that completes after ``--seconds`` does."""


def read(run):
    return len(run.requests) / run.window_s
