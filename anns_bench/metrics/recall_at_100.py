"""The final top-100 against the reference's exact top-100, averaged over
every distinct query the window answered (judge.py)."""


def read(run):
    return run.recall
