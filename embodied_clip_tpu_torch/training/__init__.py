"""DD-PPO on the port: PPO math, the optimizer, rollout collection, the learner and the
frozen encoder inside the rollout."""

from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig, DDPPOLearner, iter_minibatches
from embodied_clip_tpu_torch.training.ppo import PPOConfig, Rollout, compute_gae, ppo_loss

__all__ = ["DDPPOConfig", "DDPPOLearner", "iter_minibatches", "PPOConfig", "Rollout",
           "compute_gae", "ppo_loss"]
