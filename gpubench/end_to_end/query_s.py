"""query_s: the window's whole span, from the first query's start to
the last one's end (host clock, each round ending in a synchronize),
over the queries completed in it."""


def read(run):
    done = run.completed
    if not done:
        return None
    return (run.window_t1 - run.window_t0) / len(done)
