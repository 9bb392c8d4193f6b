"""The env inside the rollout (span `rollout.env` of `training/rollout.collect_rollout`:
GridNav's `step` over the batch): host ms an iteration."""

from benchmark.harness.program_spans import host_ms_per_unit


def read(view):
    return host_ms_per_unit(view, "rollout.env")
