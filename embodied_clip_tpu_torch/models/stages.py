"""The bottleneck stages of a ResNet trunk, routed through kernels K6/K7 when the trunk
is the folded bf16 serving configuration.

Both ResNet families of the port (CLIP's `ModifiedResNet` and torchvision's `ResNet`)
keep their blocks as `layer1` … `layerN` with torchvision/openai names (`conv1`-`conv3`,
`downsample.0`) and inherit `run_stages` from `StagesMixin`. A trunk that is BN-folded and
bf16 runs:

  stage 1   K7 `fused_stage1` when its block 0 is a stride-1 bottleneck whose shortcut
            is a 1×1 stride-1 conv and every later block is an identity bottleneck
  block     K6 `fused_bottleneck` for every other stride-1 identity bottleneck
  stride    `fused_stride_block_bf16` for CLIP's anti-aliased stride-2 bottleneck (conv2
            at stride 1, the block's stride 2, the shortcut a 2×2 average pool then a 1×1
            stride-1 conv) whose widths are multiples of 8: K6's GEMM and one pool launch
  others    the block's own forward (torchvision's strided blocks, basic blocks): cuDNN

f32 trunks and unfolded trunks take every block's own forward (cuDNN convs): the f32
trunk is the reference that tests hold K6/K7 to. The kernels' operands — 1×1 weights as
(Cin, Cout), 3×3 as HWIO, in the trunk's dtype, biases f32 — are built once, on first
use, and dropped when a state_dict loads.
On CPU tensors the kernels' wrappers take their plain versions, so the same dispatch
runs everywhere. Each step of the fused route is a span (`bf16.stage1`, `bf16.bottleneck`,
`bf16.block` around each stride-2 block and basic block, whichever route it takes; the
trunks' stems open `bf16.stem`): `utils/profiling.py`. The counters `bf16.stride_blocks`
(every stride-2 block of the plan) and `bf16.stride_fused` (those on the `stride` step)
say how much of the strided work the fused route takes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
from embodied_clip_tpu_torch.utils.profiling import count, span

__all__ = ["StagesMixin"]

# The span of each step of the fused plan (the stem's is `bf16.stem`).
_SPANS = {"stage1": "bf16.stage1", "bottleneck": "bf16.bottleneck", "stride": "bf16.block",
          "module": "bf16.block"}


def _pointwise(conv: nn.Conv2d) -> torch.Tensor:
    """1×1 OIHW conv weight → (Cin, Cout)."""
    return conv.weight[:, :, 0, 0].t().contiguous()


def _bottleneck_operands(block: nn.Module) -> Dict[str, torch.Tensor]:
    """A folded bottleneck's convs in the JAX kernels' layout: w1 (C, Cm), w2 (3, 3, Cm,
    Cm) HWIO, w3 (Cm, C'), in the block's dtype; b1, b2, b3 in f32."""
    return {"w1": _pointwise(block.conv1), "b1": block.conv1.bias.float(),
            "w2": block.conv2.weight.permute(2, 3, 1, 0).contiguous(),
            "b2": block.conv2.bias.float(),
            "w3": _pointwise(block.conv3), "b3": block.conv3.bias.float()}


def _stride1_bottleneck(block: nn.Module) -> bool:
    return (hasattr(block, "conv3") and block.conv2.stride == (1, 1)
            and getattr(block, "stride", 1) == 1)


def _identity_bottleneck(block: nn.Module) -> bool:
    return _stride1_bottleneck(block) and block.downsample is None


def _pooled_stride_bottleneck(block: nn.Module) -> bool:
    """CLIP's anti-aliased stride-2 bottleneck that `fused_stride_block_bf16` computes:
    conv2 a 3×3 at stride 1, the block's stride 2, the shortcut `AvgPool2d(2)` then a
    1×1 stride-1 conv, and every width a multiple of 8 (the GEMM's 16-byte rows)."""
    if not (hasattr(block, "conv3") and getattr(block, "stride", 1) == 2
            and block.conv2.stride == (1, 1)
            and block.downsample is not None and len(block.downsample) == 2):
        return False
    pool, conv = block.downsample
    widths = (block.conv1.in_channels, block.conv1.out_channels, block.conv3.out_channels)
    return (isinstance(pool, nn.AvgPool2d) and pool.kernel_size == pool.stride == 2
            and conv.kernel_size == (1, 1) and conv.stride == (1, 1)
            and all(c % 8 == 0 for c in widths))


def _conv_shortcut(block: nn.Module):
    """A stride-1 block's 1×1 stride-1 shortcut conv (`downsample.0`), or None."""
    if block.downsample is None:
        return None
    conv = getattr(block.downsample, "0")
    return conv if conv.kernel_size == (1, 1) and conv.stride == (1, 1) else None


class StagesMixin:
    """`layer1` … `layer{n_stages}` of an nn.Module trunk with `dtype`, `folded`."""

    def _init_stages(self) -> None:
        self._fused_ops: List = []
        self.register_load_state_dict_post_hook(lambda module, _: module._fused_ops.clear())

    @property
    def runs_fused_plan(self) -> bool:
        return self.folded and self.dtype == torch.bfloat16

    def fused_plan(self) -> List[Tuple[str, nn.Module]]:
        """The trunk's stages as steps: ('stage1', layer) for K7, ('bottleneck', block)
        for K6, ('stride', block) for CLIP's stride-2 block on the bf16 launches,
        ('module', block) for a block's own forward, in order."""
        plan = []
        for s in range(self.n_stages):
            blocks = list(getattr(self, f"layer{s + 1}"))
            if (_stride1_bottleneck(blocks[0]) and _conv_shortcut(blocks[0]) is not None
                    and all(_identity_bottleneck(b) for b in blocks[1:])):
                plan.append(("stage1", getattr(self, f"layer{s + 1}")))
                continue
            plan += [("bottleneck" if _identity_bottleneck(b) else
                      "stride" if _pooled_stride_bottleneck(b) else "module", b)
                     for b in blocks]
        return plan

    def _operands(self):
        if not self._fused_ops:
            for kind, mod in self.fused_plan():
                if kind == "stage1":
                    blocks = list(mod)
                    sc = _conv_shortcut(blocks[0])
                    ops = {"blocks": [_bottleneck_operands(b) for b in blocks],
                           "shortcut": (_pointwise(sc), sc.bias.float())}
                elif kind == "stride":
                    ds = mod.downsample[1]
                    ops = {**_bottleneck_operands(mod), "wds": _pointwise(ds),
                           "bds": ds.bias.float()}
                else:
                    ops = _bottleneck_operands(mod) if kind == "bottleneck" else None
                self._fused_ops.append((kind, mod, ops))
        return self._fused_ops

    def run_stages(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW channels-last map after the stem → the NHWC contiguous conv map."""
        if not self.runs_fused_plan:
            for s in range(self.n_stages):
                x = getattr(self, f"layer{s + 1}")(x)
            return x.permute(0, 2, 3, 1).contiguous()
        x = x.permute(0, 2, 3, 1)  # NHWC: a view of channels-last memory
        for kind, mod, ops in self._operands():
            if getattr(mod, "stride", 1) == 2:
                count("bf16.stride_blocks")
            with span(_SPANS[kind]):
                if kind == "stage1":
                    x = BK.fused_stage1(x, ops["blocks"], ops["shortcut"])
                elif kind == "bottleneck":
                    x = BK.fused_bottleneck(x, **ops)
                elif kind == "stride":
                    count("bf16.stride_fused")
                    x = BK.fused_stride_block_bf16(x, **ops)
                else:
                    x = mod(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x.contiguous()
