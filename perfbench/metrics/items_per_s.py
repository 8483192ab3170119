"""Rows offered in the window, over all shards, per second of the
window: its ticks back to back, each from the call of the program's
step to the return of the synchronize after it (host clock)."""


def read(run: dict, cell: dict):
    return run["rows"] / run["window_s"]
