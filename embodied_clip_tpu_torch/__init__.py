"""embodied-clip-tpu, PyTorch/CUDA port for one NVIDIA H100 (Hopper, sm_90a).

A second package beside `embodied_clip_tpu` (JAX, the reference). It serves frozen
CLIP ResNet features: uint8 frames → PIL-parity bicubic resize + centre crop + CLIP
normalise (kernel K1, `ops/kernels/preprocess_kernel.py`) → the bf16/f32
`ModifiedResNet` trunk, or the int8 post-training-quantized trunk (`ops/quantize.py`,
kernels K2-K5 in `ops/kernels/stem_kernel.py` and `bottleneck_kernel.py`) →
`clip_conv` / `clip_avgpool` / `clip_attnpool`. The kernels are CUDA C++ in `csrc/`.
It also trains: the DD-PPO step (`envs/`, `models/policy.py`, `training/`, `parallel/`)
with the frozen encoder inside the rollout (`examples/train_objectnav.py --frames`), and
the host-simulator path: pools of THOR/Habitat-style simulator processes
(`envs/vector.py`, `native/frame_ring.py`) feeding the encoder on the card, with host PPO,
evaluation and DAgger (`training/host_rollout.py`, `host_ppo.py`, `evaluate.py`,
`dagger.py`) and allenact's released policy (`models/allenact_policy.py`).

The package imports torch and numpy only — never jax, flax or `embodied_clip_tpu`.
Entry points run on the GPU (`device="cuda"`) unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from embodied_clip_tpu_torch import constants  # noqa: F401
from embodied_clip_tpu_torch.ops.preprocess import Preprocessor, make_preprocessor
from embodied_clip_tpu_torch.ops.resize import resample_weights, resize_plan

__all__ = ["Preprocessor", "make_preprocessor", "resample_weights", "resize_plan"]
