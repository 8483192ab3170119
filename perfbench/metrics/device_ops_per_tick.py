"""Device operations (kernels, copies, sets) a graphed tick, from the
``torch.profiler`` trace of the traced ticks."""


def read(run: dict, cell: dict):
    g = run.get("graphed")
    if not g or not g["ops"]:
        return None
    return g["ops"] / run["traced_ticks"]
