"""Utilities (port of `embodied_clip_tpu/utils/`): seeding, step and best-value
checkpoints, the TensorBoard event writer, stage timing."""
