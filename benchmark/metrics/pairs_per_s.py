"""pairs_per_s: the pairs of every whole call of the window over the time
from the window's start to the end of its last whole call (host clock; a
call ends when its p is on the host)."""


def read(run):
    if not run.calls:
        return None
    return len(run.calls) * run.cell.mix["batch"] / (run.calls[-1].end - run.window_start)
