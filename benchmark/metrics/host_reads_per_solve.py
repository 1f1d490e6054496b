"""Values the fused runner's solve reads from the card into Python, counted
over one request's ``make_fused_run`` call and run (the CLI's cost read
included)."""


def read(run):
    if run.reads is None or run.cell.traffic["runner"] != "fused":
        return None
    return float(run.reads["reads"])
