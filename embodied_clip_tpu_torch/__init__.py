"""embodied-clip-tpu, PyTorch/CUDA port for one NVIDIA H100 (Hopper, sm_90a).

A second package beside `embodied_clip_tpu` (JAX, the reference). It serves frozen
CLIP ResNet features: uint8 frames → PIL-parity bicubic resize + centre crop + CLIP
normalise (kernel K1, `ops/kernels/preprocess_kernel.py`) → the bf16/f32
`ModifiedResNet` trunk, or the int8 post-training-quantized trunk (`ops/quantize.py`,
kernels K2-K5 in `ops/kernels/stem_kernel.py` and `bottleneck_kernel.py`) →
`clip_conv` / `clip_avgpool` / `clip_attnpool`; and the CLIP ViTs (`models/clip_vit.py`,
`clip_embed`, bf16/f32 or int8 through `ops/quantize_vit.py`). The kernels are CUDA C++
in `csrc/`. The text tower, the tokenizer and the dual-tower CLIP (`models/clip_text.py`,
`tokenizer.py`, `clip.py`) give zero-shot ObjectNav its goal table (`zeroshot/`,
`config/rl_experiments._GoalMappedEnv`).
It also trains: the DD-PPO step (`envs/`, `models/policy.py`, `training/`, `parallel/`)
with the frozen encoder inside the rollout (`examples/train_objectnav.py --frames`), and
the host-simulator path: pools of THOR/Habitat-style simulator processes
(`envs/vector.py`, `native/frame_ring.py`) feeding the encoder on the card, with host PPO,
evaluation and DAgger (`training/host_rollout.py`, `host_ppo.py`, `evaluate.py`,
`dagger.py`) and allenact's released policy (`models/allenact_policy.py`). The RL
experiments run by name (`config/experiments.get_experiment`, `config/rl_experiments.py`:
train with step checkpoints and resume, evaluate into metrics.json), with seeding, the
checkpoints and TensorBoard events in `utils/`. The primitive-probing stack extracts
feature stores of simulator frames through the encoders (`generate_data/`,
`data/feature_store.py`) and trains the reference's linear probes on them
(`models/probes.py`, `data/probing.py`, `training/supervised.py`, the `probe_*`
experiments); `parity.verify_encoder_parity` holds an encoder to a reference capture, and
`python -m embodied_clip_tpu_torch` (`cli.py`) runs all of it from the command line.

The package imports torch and numpy only — never jax, flax or `embodied_clip_tpu`.
Entry points run on the GPU (`device="cuda"`) unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from embodied_clip_tpu_torch import constants  # noqa: F401
from embodied_clip_tpu_torch.ops.preprocess import Preprocessor, make_preprocessor
from embodied_clip_tpu_torch.ops.resize import resample_weights, resize_plan

__all__ = ["Preprocessor", "make_preprocessor", "resample_weights", "resize_plan"]
