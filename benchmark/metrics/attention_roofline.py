"""The fused attention launch (span `attn.core` of `models/transformer.MultiHeadAttention`):
the attention's work (`work/clip_vision_transformer.py` `attention`: the two products at
the bf16 peak, q, k and v read once and the output written once) over the span's stream
time, percent. None where the program records no such span or the work has no
attention."""

from benchmark.harness import device as card
from benchmark.harness.program_spans import recording


def read(view):
    rec = recording()
    st = None if rec is None else rec.by_name().get("attn.core")
    if st is None or not st.stream_s or "attention" not in view.work:
        return None
    return 100.0 * card.least_seconds(view.work["attention"]) * view.units / st.stream_s
