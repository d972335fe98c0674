"""The ctypes signatures in kernels/build.py against the extern "C" entries
of kernels/csrc/*.cu, read from the sources (no compiler needed): the same
entries, and for each the same number of arguments with the same kind
(pointer, or an integer of the same width and signedness) and return
type. ctypes passes whatever it is told, so a stale signature would only
show on the card, as a wrong result or a fault."""

import ctypes
import re

import pytest

from twopaco_tpu_torch.kernels import build

_DECL = re.compile(r'extern "C"\s+([\w\s\*]+?)\s*\b(tp_\w+)\s*\(([^)]*)\)\s*\{')
_C_INTS = {  # C integer type -> (bytes, signed)
    "int": (4, True), "long long": (8, True), "uint32_t": (4, False),
    "unsigned": (4, False), "size_t": (8, False), "unsigned long long": (8, False),
}
_SIGNED = (ctypes.c_int, ctypes.c_longlong)


def _entries() -> dict:
    src = "".join(p.read_text() for p in sorted(build.CSRC.glob("*.cu")))
    return {m.group(2): (m.group(1), m.group(3)) for m in _DECL.finditer(src)}


def _c_kind(decl: str):
    """A C parameter or return type ('const uint32_t* tabs', 'int') -> 'p'
    or (bytes, signed)."""
    if "*" in decl:
        return "p"
    words = [w for w in decl.split() if w != "const"]
    return _C_INTS[" ".join(words[:-1])]  # the last word is the name


def _ctypes_kind(t):
    if t in (ctypes.c_void_p, ctypes.c_char_p) or issubclass(t, ctypes._Pointer):
        return "p"
    return (ctypes.sizeof(t), t in _SIGNED)


ENTRIES = _entries()


def test_every_entry_is_bound():
    assert set(ENTRIES) == set(build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(build._SIGNATURES))
def test_signature_matches_the_source(name):
    ret, params = ENTRIES[name]
    args, restype = build._SIGNATURES[name]
    got = [_c_kind(p) for p in params.split(",")] if params.strip() else []
    assert got == [_ctypes_kind(a) for a in args]
    assert _c_kind(ret + " r") == _ctypes_kind(restype)
