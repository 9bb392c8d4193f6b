"""K1 layer (`ops/preprocess.py`): its least time at the peaks (bytes-bound: uint8
frames in, the bf16 image out) over the device time of the kernels launched inside
`Preprocessor.__call__`, percent."""


def read(view):
    return view.roofline("preprocess")
