"""The engine loop's ms per block update: the traced run's 'run' spans
(``RBCDEngine.run``) over the updates the engine reports."""


def read(run):
    if run.cell.traffic["runner"] != "engine":
        return None
    it = sum(r["iterations"] for r in run.requests if "run" in r["spans"])
    s = sum(r["spans"]["run"] for r in run.requests if "run" in r["spans"])
    return s / it * 1e3 if it else None
