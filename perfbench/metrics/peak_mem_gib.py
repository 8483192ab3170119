"""``torch.cuda.max_memory_allocated()`` over set-up and window, on the
fullest card, in GiB."""


def read(run: dict, cell: dict):
    return run["peak_bytes"] / 2 ** 30
