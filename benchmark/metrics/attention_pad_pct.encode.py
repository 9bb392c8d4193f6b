"""The attention launch's padding: the share of the multiply-adds it issues (counter
`attn.issued_macs`: its 64-row warpgroup tiles against the keys its key tiles issue)
that the attention does not need (`attn.useful_macs`: 2·T²·C a frame and layer),
percent."""

from benchmark.harness.program_spans import counter_pct


def read(view):
    useful = counter_pct("attn.useful_macs", "attn.issued_macs")
    return None if useful is None else 100.0 - useful
