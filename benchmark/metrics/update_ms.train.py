"""The PPO update (`DDPPOLearner.update` -> `training/ppo.py`, `optim.py` and the
all-reduce): host-clock ms a call, synchronised at its end, over the traced run's
window."""


def read(view):
    return view.host_ms("ppo_update")
