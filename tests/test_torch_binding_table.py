"""``ops/_build.SIGNATURES``, the one place the port's Python side writes a
kernel library's C interface, held to the sources: every function that
``extern "C"`` exports in ``csrc/<name>.cu`` is listed for ``name``, with
the same result and the same kind (pointer, int, long long, float) at each
parameter; and ``_build.swapped`` puts the library it replaced back on exit,
whatever the block raised.  No nvcc: the sources are read as text, and the
swap loads stub libraries built with the C compiler."""

import ctypes
import re
import shutil
import subprocess

import pytest

from distantspeech_tpu_torch.ops import _build

# a C declaration's type -> the table's letter for it
_KINDS = {"int": "i", "cudaError_t": "i", "long long": "q", "float": "f", "char*": "s", "int*": "I",
          "long long*": "Q"}


def _kind(decl: str) -> str:
    """'const void* farp' -> 'p', 'int M' -> 'i', 'long long* smem' -> 'Q'."""
    t = re.sub(r"\s+", " ", re.sub(r"\bconst\b|\w+\s*$", "", decl)).replace(" *", "*").strip()
    return _KINDS.get(t, "p" if t.endswith("*") else "?")


def exported(name: str) -> dict:
    """{function: "result(parameters)"} of the ``extern "C"`` block of
    csrc/<name>.cu, in the table's letters."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    block = re.search(r'extern "C" \{(.*)\}\s*// extern "C"', src, re.S).group(1)
    block = re.sub(r"//[^\n]*", "", block)
    fns = {}
    for m in re.finditer(r"^([A-Za-z_][\w ]*?\**)\s*(\w+)\(([^()]*)\)\s*\{", block, re.M):
        params = [p for p in m.group(3).split(",") if p.strip()]
        fns[m.group(2)] = f"{_kind(m.group(1) + ' r')}({''.join(_kind(p) for p in params)})"
    return fns


_STUB = """
int fused_srp_launch(const void* y, const void* G, void* out, int R, int F, int M, int Theta, void* stream) {
  return TAG * 100 + R;
}
const char* srp_error_string(int err) { return err != 3 ? "other" : TAG == 1 ? "stub 1" : "stub 2"; }
"""


def _swap(tmp_path):
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler for the stub libraries")
    src = tmp_path / "stub.c"
    src.write_text(_STUB)
    libs = []
    for tag in (1, 2):
        lib = tmp_path / f"stub{tag}.so"
        subprocess.run([cc, "-shared", "-fPIC", f"-DTAG={tag}", "-o", str(lib), str(src)], check=True, timeout=60)
        libs.append(lib)
    launch = lambda: _build.load("srp").fused_srp_launch(None, None, None, 5, 1, 2, 1, None)  # noqa: E731
    with _build.swapped("srp", libs[0]) as first:
        assert launch() == 105 and _build.load("srp") is first
        with _build.swapped("srp", libs[1]):
            assert launch() == 205
        assert launch() == 105
        with pytest.raises(KeyError):
            with _build.swapped("srp", libs[1]):
                assert launch() == 205
                raise KeyError("inside")
        assert launch() == 105
        # typed from the table: a float where the launcher takes an int is refused
        with pytest.raises(ctypes.ArgumentError):
            _build.load("srp").fused_srp_launch(None, None, None, 5.5, 1, 2, 1, None)
        with pytest.raises(RuntimeError, match=r"stub 1 \(3\)"):
            _build.check_launch("srp", 3, "fused_srp_spectrum")


@pytest.mark.parametrize("case", sorted(p.stem for p in _build.CSRC.glob("*.cu")) + ["swap"])
def test_the_binding_table_matches_the_sources(case, tmp_path):
    if case == "swap":
        _swap(tmp_path)
        return
    assert case in _build.SIGNATURES, f"csrc/{case}.cu has no entry in _build.SIGNATURES"
    assert exported(case) == _build.SIGNATURES[case]
