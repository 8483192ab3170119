"""The share of the traced graphed ticks' wall time in which no
operation ran on the card (rank 0's card across ranks), in percent:
the union of the device's operations in the ``torch.profiler`` trace
against the stretch's length.  The profiler slows the host's side of a
tick (a graph launch's host time about doubles), so this reads higher
than the share of the untraced window; across ranks a collective's
kernel counts as busy while it waits for its peers."""


def read(run: dict, cell: dict):
    g = run.get("graphed")
    if not g or g["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - g["busy_s"] / g["window_s"])
