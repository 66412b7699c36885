"""The ctypes signatures of the port's CUDA entry points against their C
sources.

``yume_tpu_torch._build`` binds each ``extern "C"`` function of
``yume_tpu_torch/csrc/*.cu`` with an argument list written by hand. A list
that disagrees with the source in length or in the kind of an argument
(pointer, int, 64-bit int, float) passes the wrong bits on the card without
any error, so each list is held here to the declaration it binds.
"""

import ctypes
import glob
import os
import re

import pytest

from yume_tpu_torch import _build

_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_longlong: "int64",
          ctypes.c_float: "float"}


def _kind(arg: str) -> str:
    if "*" in arg:
        return "pointer"
    if "long long" in arg:
        return "int64"
    if "float" in arg:
        return "float"
    if re.search(r"\bint\b", arg):
        return "int"
    raise ValueError(f"unknown C argument type: {arg!r}")


def _entry_points() -> dict:
    """{name: [argument kind, ...]} of every extern "C" function in csrc/."""
    found = {}
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        for name, args in re.findall(r'extern "C"[^(]*?\b(yume_\w+)\(([^)]*)\)', src):
            found[name] = [_kind(a) for a in args.split(",") if a.strip()]
    return found


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signatures_match_sources(name):
    sources = _entry_points()
    assert name in sources, f"{name} is bound but no source declares it"
    assert [_KINDS[t] for t in _build._SIGNATURES[name]] == sources[name]


def test_every_entry_point_is_bound():
    sources = _entry_points()
    # the error-string lookup is bound apart: it returns a C string
    assert sources.pop("yume_error_string") == ["int"]
    assert set(sources) == set(_build._SIGNATURES)
