"""setup_s: from the process's start to the window's: imports, the
graph drawn and uploaded, the engine's statistics, each query kind's
plan search, compile and first count (host clock)."""


def read(run):
    return run.setup_s
