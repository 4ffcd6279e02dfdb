"""dispatches_per_query: the chunk loop's dispatches
(`engine.last_round_dispatches`, summed over the window's rounds) over
the queries completed in the window; an exact count."""


def read(run):
    done = run.completed
    if not done:
        return None
    return sum(q.dispatches for q in done) / len(done)
