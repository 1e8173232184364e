"""Process start to window start: library load from its cache, the
problem, the setup, the compile, the warm-up."""


def read(run):
    return run.setup_s
