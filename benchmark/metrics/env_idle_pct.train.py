"""The card waiting on the env: the share of the traced window in which it is idle while
the innermost program span open on the host lies under `rollout.env`, percent."""

from benchmark.harness.program_spans import idle_pct_under


def read(view):
    return idle_pct_under(view, ("rollout.env",))
