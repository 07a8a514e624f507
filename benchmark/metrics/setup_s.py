"""setup_s: seconds from process start to the first timed job (imports,
the kernel library's build or load, the inputs, the warm-up)."""


def read(run):
    return run.setup_s
