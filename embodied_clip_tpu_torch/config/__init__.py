"""Experiment configuration (port of `embodied_clip_tpu/config/`): so far the RL
registry's goal wrapper (`rl_experiments._GoalMappedEnv`)."""
