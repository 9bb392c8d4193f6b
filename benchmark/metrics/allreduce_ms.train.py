"""The gradient exchange in the PPO update (span `update.allreduce` of
`training/ddppo.ppo_update`: the gradients flattened, NCCL's all-reduce over the cards,
copied back), on rank 0: its stream time an iteration, ms. The compute stream waits in
it for the all-reduce, and the all-reduce for the slowest rank, so it reads the
exchange and the wait for stragglers that the compute does not hide (its host time is
only the launches: NCCL's all-reduce does not hold the host). Read only across cards."""

from benchmark.harness.program_spans import stream_ms_per_unit


def read(view):
    return stream_ms_per_unit(view, "update.allreduce") if view.ranks else None
