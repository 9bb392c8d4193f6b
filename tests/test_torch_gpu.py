"""The port's CUDA kernels on the card, each held to its plain PyTorch version.

Marked `gpu`: each test skips where no CUDA device is present (decided inside the
test). This file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from embodied_clip_tpu_torch import constants
from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K
from embodied_clip_tpu_torch.parity import golden_frames

pytestmark = pytest.mark.gpu
MEAN, STD = constants.CLIP_MEAN, constants.CLIP_STD


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    return torch.device("cuda")


@pytest.mark.parametrize("n,in_hw,size", [(8, (300, 300), 224), (3, (160, 120), 224),
                                          (2, (301, 299), 224), (2, (480, 640), 384)])
def test_fused_preprocess_kernel_matches_plain_version(cuda, n, in_hw, size):
    frames = np.random.RandomState(0).randint(0, 256, (n, *in_hw, 3), np.uint8)
    x = torch.from_numpy(frames).to(cuda)
    before = K.fused_preprocess.launches
    got = K.fused_preprocess(x, size, MEAN, STD, dtype=torch.float32)
    got_bf16 = K.fused_preprocess(x, size, MEAN, STD, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert K.fused_preprocess.launches == before + 2
    ref = K.fused_preprocess_reference(x, size, MEAN, STD, dtype=torch.float32)
    lsb = 1.0 / 255.0 / min(STD)
    err = (got - ref).abs()
    assert float(err.max()) <= 1.5 * lsb
    assert float((err > 0.5 * lsb).float().mean()) < 1e-3
    assert torch.equal(got_bf16, got.to(torch.bfloat16))


def test_fused_preprocess_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.from_numpy(golden_frames(2)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_preprocess(x[:, :, ::2], 224, MEAN, STD)
    with pytest.raises(ValueError, match="uint8"):
        K.fused_preprocess(x.float(), 224, MEAN, STD)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.fused_preprocess(x, 224, MEAN, STD, dtype=torch.float16)
