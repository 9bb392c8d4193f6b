"""The trainer's rollout (`DDPPOLearner.collect`: the env, the policy and the
in-rollout encode of T steps): host-clock ms a call, synchronised at its end, over the
traced run's window."""


def read(view):
    return view.host_ms("trainer_rollout")
