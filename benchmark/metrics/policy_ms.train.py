"""The policy inside the rollout (span `rollout.policy` of
`training/rollout.collect_rollout`: forward, sampling, log-probability, and the bootstrap
value): host ms an iteration."""

from benchmark.harness.program_spans import host_ms_per_unit


def read(view):
    return host_ms_per_unit(view, "rollout.policy")
