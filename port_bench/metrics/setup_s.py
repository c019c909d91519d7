"""setup_s: process start to the window's start (kernel load or build,
the observations, every initial_fit and the warm predict), host clock."""


def read(run):
    return run.setup_s
