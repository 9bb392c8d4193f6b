"""The entry's copy of the request's frames to the card (span `encode.to_device` of
`FrozenEncoder.encode`: a pageable host-to-device copy of the numpy frames): host ms a
request."""

from benchmark.harness.program_spans import host_ms_per_unit


def read(view):
    return host_ms_per_unit(view, "encode.to_device")
