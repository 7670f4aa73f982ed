"""active_pair_share: the pair-trips the solver used over those it ran.
Each trip forms and solves the system of all B pairs of the call, and only
the pairs still active take the result: per call, the sum of its
`level_niters` over pairs and levels over B x its `ica.trip` spans; the
ratio of the sums over the calls of the spans' window
(benchmark/yardstick/spans.py)."""

from benchmark.yardstick import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    trips = int(sp.named("ica.trip").sum())
    used = sum(int(n.sum()) for levels in sp.level_niters for n in levels)
    if not trips or not used:
        return None
    return used / (sp.batch * trips)
