"""Launch dispatch: the share of the traced window in which the card is idle while the
innermost program span open on the host lies under `encode.trunk` or `encode.heads`
(the host launching the trunk's and the heads' kernels), percent."""

from benchmark.harness.program_spans import idle_pct_under


def read(view):
    return idle_pct_under(view, ("encode.trunk", "encode.heads"))
