"""trips_per_call: the program's K1 launch counter over the window's whole
calls, per call: solver trips summed over the pyramid's levels."""


def read(run):
    if not run.calls or run.calls[-1].k1_launches == run.k1_start:
        return None
    return (run.calls[-1].k1_launches - run.k1_start) / len(run.calls)
