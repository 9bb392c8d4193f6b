"""The in-rollout encoder (`FrameEncoder.__call__`: K1, the int8 trunk, the heads):
device ms of its kernels per iteration in the traced stretch."""


def read(view):
    return view.device_ms_per_unit("rollout_encoder")
