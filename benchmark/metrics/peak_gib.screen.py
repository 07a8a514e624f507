"""torch.cuda.max_memory_allocated over the window (reset at its start),
GiB."""

from harness.readers import peak_gib


def read(run):
    return peak_gib(run)
