"""The one seam that binds the port's CUDA libraries (`ops/kernels/_build.Library`), on
the CPU.

A small C library with the sources' contract (entry points that return an error code
named by `ect_error_string`, and a count query) is compiled with the host's C compiler
and bound through `Library.variant`: a launch that fails raises with the entry point's
name and the library's own message, a count comes back as a 64-bit integer, and every
entry point is bound once. The declarations of the six real sources are checked against
their `.cu` files without building them.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

from embodied_clip_tpu_torch.ops.kernels import _build
from embodied_clip_tpu_torch.ops.kernels import attention_kernel as AK
from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
from embodied_clip_tpu_torch.ops.kernels import pointwise_kernel as PK
from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K
from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK

FAKE_SOURCE = r"""
static const char *messages[] = {"no error", "n must be positive", "no such device"};
const char *ect_error_string(int err) { return err >= 0 && err < 3 ? messages[err] : "?"; }
int ect_fill(int *out, int n, int value, int device, void *stream) {
    (void)stream;
    if (n <= 0) return 1;
    if (device != 0) return 2;
    for (int i = 0; i < n; ++i) out[i] = value + i;
    return 0;
}
long long ect_fill_words(int m, int n) { return (long long)m * n * 1000003LL; }
"""

LIBRARIES = {"bottleneck_int8": BK.LIB_INT8, "bottleneck_bf16": BK.LIB_BF16,
             "stem_int8": SK.LIB, "preprocess": K.LIB, "attention_bf16": AK.LIB,
             "pointwise_bf16": PK.LIB}


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    """`Library` bound to the fake source's shared library."""
    cc = shutil.which("cc") or shutil.which("gcc")
    assert cc, "a C compiler builds the fake library"
    root = tmp_path_factory.mktemp("fake_lib")
    src, lib = root / "fake.c", root / "libfake.so"
    src.write_text(FAKE_SOURCE)
    subprocess.run([cc, "-shared", "-fPIC", "-O1", "-o", str(lib), str(src)], check=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.Library("fake", {"ect_fill": [p, i, i, i, p]},
                          sizes={"ect_fill_words": [i, i]}).variant(str(lib))


def test_a_launch_runs_or_raises_with_the_librarys_message(fake):
    out = np.zeros(4, np.int32)
    assert fake.ect_fill(out.ctypes.data, 4, 7, 0, None) is None
    assert out.tolist() == [7, 8, 9, 10]
    with pytest.raises(RuntimeError, match="ect_fill launch failed: n must be positive"):
        fake.ect_fill(out.ctypes.data, 0, 7, 0, None)
    with pytest.raises(RuntimeError, match="ect_fill launch failed: no such device"):
        fake.ect_fill(out.ctypes.data, 4, 7, 3, None)


def test_counts_come_back_as_64_bit_integers(fake):
    assert fake.ect_fill_words(70_000, 50_000) == 70_000 * 50_000 * 1000003


def test_entry_points_are_bound_once_and_only_those_declared(fake):
    first = fake.ect_fill
    assert fake.ect_fill is first and fake.__dict__["ect_fill"] is first
    with pytest.raises(AttributeError):
        fake.ect_error_string  # bound by the seam, not handed out
    with pytest.raises(AttributeError):
        fake.ect_undeclared


def test_nothing_is_built_or_loaded_on_import():
    for lib in LIBRARIES.values():
        assert lib.path is None
        assert not any(name in lib.__dict__ for name in (*lib.entries, *lib.sizes))


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _c_interface(source: str) -> dict:
    """{name: (return type, [argument ctypes])} of every `extern "C"` function of
    `csrc/<source>.cu`; a pointer argument is a `c_void_p`."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    out = {}
    for ret, name, params in re.findall(r'extern "C" ([\w ]+?\*?) (ect_\w+)\(([^)]*)\)', text):
        args = []
        for param in filter(None, (q.strip() for q in params.split(","))):
            kind = param.rsplit(" ", 1)[0].replace("const ", "")
            args.append(ctypes.c_void_p if "*" in kind else _C_TYPES[kind])
        out[name] = (ret, args)
    return out


@pytest.mark.parametrize("source", sorted(LIBRARIES))
def test_declarations_match_the_sources_c_interface(source):
    """Each source's `extern "C"` functions are exactly its declared entry points
    (returning an int error code), its count queries (returning a long long) and
    `ect_error_string`, with the argument types the source gives; every entry point takes
    its device index and its CUDA stream last (`_build.stream`)."""
    lib = LIBRARIES[source]
    assert lib.source == source and source in _build.SOURCES
    c = _c_interface(source)
    assert c.pop("ect_error_string") == ("const char*", [ctypes.c_int])
    assert set(c) == set(lib.entries) | set(lib.sizes)
    for name, args in lib.entries.items():
        assert c[name] == ("int", list(args)), name
        assert list(args[-2:]) == [ctypes.c_int, ctypes.c_void_p], name
    for name, args in lib.sizes.items():
        assert c[name] == ("long long", list(args)), name
