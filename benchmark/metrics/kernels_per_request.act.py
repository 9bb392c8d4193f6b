"""Device kernels (copies and sets left out) launched per request in the traced
stretch: the host dispatch of `FrozenEncoder.encode`, an exact count."""


def read(view):
    return view.kernels_per_unit()
