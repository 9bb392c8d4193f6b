"""Data generation (port of `embodied_clip_tpu/generate_data/`): THOR frames, the
reachability metadata, and feature extraction through the frozen encoders."""
