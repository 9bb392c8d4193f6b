"""Zero-shot ObjectNav via frozen CLIP text-goal embeddings (port of
`embodied_clip_tpu/zeroshot/__init__.py`).

The reference's zeroshot-objectnav branch swaps the policy's learned object-type
embedding for frozen CLIP text-encoder embeddings of the class names, trains DD-PPO on
8 seen classes, and evaluates on 4 unseen ones (readme_files/zeroshot_objectnav.md:
3-8, 31-32). Here: build a (num_classes, D) normalised text-embedding table once on the
CLIP's device, condition the policy with goal_kind='text_embed', and map integer goal
ids → table rows inside the rollout (`config/rl_experiments._GoalMappedEnv`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from embodied_clip_tpu_torch.constants import (
    ROBOTHOR_OBJECT_TYPES,
    ZEROSHOT_SEEN_OBJECTS,
    ZEROSHOT_UNSEEN_OBJECTS,
)
from embodied_clip_tpu_torch.models.tokenizer import tokenize

__all__ = ["text_goal_table", "goal_map_fn", "seen_unseen_class_ids", "DEFAULT_PROMPT"]

DEFAULT_PROMPT = "a photo of a {}."


@torch.no_grad()
def text_goal_table(clip, tokenizer, class_names: Sequence[str],
                    prompt: str = DEFAULT_PROMPT, context_length: int = 77) -> torch.Tensor:
    """Encode the class names with the frozen CLIP text tower → (C, D) f32 rows of unit
    L2 norm, on the CLIP's device."""
    texts = [prompt.format(n.lower()) for n in class_names]
    tokens = tokenize(texts, tokenizer, context_length=context_length, truncate=True)
    emb = clip.encode_text(torch.from_numpy(tokens)).float()
    return emb / emb.norm(dim=-1, keepdim=True)


def goal_map_fn(table: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """goal ids (B,) int, on the table's device → (B, D) rows of `table`."""
    def fn(goal_ids: torch.Tensor) -> torch.Tensor:
        return table[goal_ids.long()]

    return fn


def seen_unseen_class_ids(class_names: Optional[Sequence[str]] = None):
    """Index the zero-shot seen/unseen split into a class-name vocabulary."""
    names = list(class_names or ROBOTHOR_OBJECT_TYPES)
    seen = tuple(names.index(n) for n in ZEROSHOT_SEEN_OBJECTS if n in names)
    unseen = tuple(names.index(n) for n in ZEROSHOT_UNSEEN_OBJECTS if n in names)
    return seen, unseen
