"""Set-up seconds: from the process's start to the window's, with imports,
the kernels' build or load, the graphs and the warm-up requests."""


def read(run):
    return run.setup_s
