"""How far the slowest rank's rollout lags the others: 100 x (the slowest rank's mean
host ms a `rollout` span (`training/rollout.collect_rollout`) minus the median rank's)
over the median rank's, over the traced iterations, from every rank's host times
gathered to rank 0 after the window. Read only across cards."""

import statistics

from benchmark.harness.program_spans import rank_host_ms


def read(view):
    ms = rank_host_ms(view, "rollout")
    if ms is None:
        return None
    mid = statistics.median(ms)
    return 100.0 * (max(ms) - mid) / mid
