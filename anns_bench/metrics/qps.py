"""Queries answered in the window a second: the rows of every request
answered before the window closed, over the window's seconds (a request
that failed answered nothing)."""


def read(run):
    done = sum(run.rows for r in run.reqs if r.ok and r.t_done <= run.deadline)
    return done / run.seconds
