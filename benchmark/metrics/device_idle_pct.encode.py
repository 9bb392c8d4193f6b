"""The share of the traced window in which no kernel or copy ran on the card, percent."""


def read(view):
    return view.idle_pct()
