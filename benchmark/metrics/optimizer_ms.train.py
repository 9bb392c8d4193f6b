"""The optimizer in the PPO update (span `update.optimizer` of
`training/ddppo.ppo_update`: `ClippedAdam.step`, the global-norm clip and Adam): host ms
an iteration."""

from benchmark.harness.program_spans import host_ms_per_unit


def read(view):
    return host_ms_per_unit(view, "update.optimizer")
