"""Seconds from the start of the process to the first timed tick:
imports, CUDA (and NCCL) start, kernel build or load, state, feed pool,
warm-up and graph capture (host clock)."""


def read(run: dict, cell: dict):
    return run["setup_s"]
