"""The whole encode step: the model's operations per batch (trunk and heads, as
published) at each declared precision's dense peak, over the traced window's time per
batch, percent."""


def read(view):
    return view.mfu()
