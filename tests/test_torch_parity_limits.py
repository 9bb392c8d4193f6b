"""The share limit K6/K7 calls are held to on the card (`parity.bf16_share_limit`): 1%
for every bottleneck of the RN50 trunks (CLIP and torchvision), whose longest reduction
is stage 4's 3×3 conv over 512 channels; beyond that length it grows in proportion, to
1.5% at RN50x16's stage 4 (a 3×3 conv over 768 channels)."""

import pytest
import torch

from embodied_clip_tpu_torch.models.clip_resnet import CLIP_RESNET_CONFIGS
from embodied_clip_tpu_torch.parity import BF16_KERNEL_SHARE, bf16_share_limit


def _block(cin, cm, cout):
    return {"w1": torch.empty(cin, cm), "w2": torch.empty(3, 3, cm, cm),
            "w3": torch.empty(cm, cout)}


def _stage_blocks(width, stage):
    """The identity bottleneck of stage `stage` (0-based) of a CLIP ResNet of `width`."""
    cm = width * 2 ** stage
    return [_block(4 * cm, cm, 4 * cm)]


@pytest.mark.parametrize("name,stage,want", [
    ("RN50", 0, 0.01), ("RN50", 1, 0.01), ("RN50", 2, 0.01), ("RN50", 3, 0.01),
    ("RN50x16", 0, 0.01), ("RN50x16", 1, 0.01), ("RN50x16", 2, 0.01),
    ("RN50x16", 3, 0.015)])
def test_share_limit_by_stage(name, stage, want):
    width = CLIP_RESNET_CONFIGS[name]["width"]
    assert bf16_share_limit(_stage_blocks(width, stage)) == pytest.approx(want)


def test_share_limit_takes_the_longest_reduction_of_a_stage1_call():
    """K7's limit is set by its longest block; a 1×1 over more input channels than the
    3×3's terms sets it too."""
    assert bf16_share_limit([_block(64, 64, 256), _block(256, 64, 256)]) == BF16_KERNEL_SHARE
    assert bf16_share_limit([_block(9216, 64, 256)]) == pytest.approx(0.02)
