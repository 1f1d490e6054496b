"""Values the engine loop reads from the card into Python per block update,
counted over one request's ``RBCDEngine.run``."""


def read(run):
    if run.reads is None or run.cell.traffic["runner"] != "engine" or not run.reads["iterations"]:
        return None
    return run.reads["reads"] / run.reads["iterations"]
