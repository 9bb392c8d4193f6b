"""Experiment configuration (port of `embodied_clip_tpu/config/`): the registry
(`experiments.register`, `list_experiments`, `get_experiment`) and the RL experiments
registered under the JAX package's names (`rl_experiments.NavRLExperiment`: train,
resume from step checkpoints, evaluate into metrics.json)."""
