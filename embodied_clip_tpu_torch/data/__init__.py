"""Probe data (port of `embodied_clip_tpu/data/`): cached-feature loading and batching
(`probing.py`), and the feature-store writer (`feature_store.py`)."""
