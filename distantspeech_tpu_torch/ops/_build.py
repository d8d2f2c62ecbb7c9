"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/kernels/`` at the
repository root, keyed by a hash of every source in ``csrc/`` and of the
flags; the wrappers load it with ``ctypes``.  Nothing is compiled when a
module is imported: the first kernel call builds, and ``build()`` builds
every source at once, one ``nvcc`` process per source, all started
together.  A failed compile raises with nvcc's output.  ptxas's register and
spill report for each library is kept beside it as ``<name>-<hash>.log``.

The C interface of every library is written here once, in ``SIGNATURES``:
``load`` types a library's exported functions from it when it first loads
the library, and ``swapped`` loads another build of a source (an edited
copy, other flags, the CPU rehearsal's g++ build) in its place for a block.
Every library exports ``<name>_error_string(int)``; ``check_launch`` raises
with it when a launcher returns a CUDA error, and ``check_tensors`` holds
the wrappers' arguments to what the kernels take.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# mvdr.cu (K1) compiles without fused multiply-adds.  K1 is held against
# its plain version fed the same gate, and a guarded gate leaves lanes whose
# loaded covariance is ill-conditioned enough to amplify a last-bit
# difference to 1e-3 of the output; without contraction each operation
# rounds as PyTorch's elementwise operations do.  sgsc.cu (K9) likewise: its
# McSpp speech presence passes through the inverses of noise covariances
# loaded by as little as 1e-4, which amplify a last-bit difference in the
# same way.  mcra.cu likewise, so that the thresholded S / Smin > delta_s
# sees the plain version's values: it is bound by bytes, so contraction
# would buy it nothing.
SOURCE_FLAGS = {"mvdr": ("-fmad=false",), "sgsc": ("-fmad=false",), "mcra": ("-fmad=false",)}

# csrc/<name>.cu -> {exported function: "result(arguments)"}: p a pointer,
# i an int (cudaError_t too), q a long long, f a float, s a C string, I an
# int*, Q a long long*.  Each launcher takes its params struct (K10's has
# none) and the stream last; each *_scratch_floats says how many floats of
# global scratch its launch needs, -1 for a shape the launcher does not take.
SIGNATURES = {name: {**fns, f"{name}_error_string": "s(i)"} for name, fns in {
    "aec": {"fused_aec_launch": "i(pppppiiiiipp)", "fused_aec_layout": "i(iiiQ)"},  # K7
    "enhance": {"fused_enhance_scratch_floats": "q(iii)", "fused_enhance_launch": "i(pppppiiiipp)",  # K2
                "fused_enhance_full_scratch_floats": "q(ii)", "fused_enhance_full_launch": "i(pppppiiiifpp)"},  # K4
    "fdgsc": {"fused_fdgsc_scratch_floats": "q(iii)", "fused_fdgsc_launch": "i(pppppppppiiiipp)"},  # K8
    "flms": {"fused_tdgsc_scratch_floats": "q(iiii)", "fused_tdgsc_launch": "i(ppppppppiiiipp)"},  # K5
    "gsc_front": {"gsc_front_scratch_floats": "q(iiii)", "gsc_front_launch": "i(piippppppppiiiiipp)"},
    "kws": {"fused_kws_launch": "i(pppppiiiipp)"},  # K6
    "mcra": {"mcra_launch": "i(pppppiiipp)"},
    "mvdr": {"fused_mvdr_scan_launch": "i(ppppppiiiipp)"},  # K1
    "sgsc": {"fused_sgsc_launch": "i(pppppppiiipp)"},  # K9
    "srp": {"fused_srp_launch": "i(pppiiiip)"},  # K10
    "wpe": {"wpe_shape": "i(iiiIIIQ)", "wpe_launch": "i(pqqqqpiiiiiipp)"},
}.items()}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong, "f": ctypes.c_float,
           "s": ctypes.c_char_p, "I": ctypes.POINTER(ctypes.c_int), "Q": ctypes.POINTER(ctypes.c_longlong)}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (put the CUDA toolkit's bin on PATH or set CUDA_HOME)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + repr(sorted(SOURCE_FLAGS.items())).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def start_nvcc(name: str, out: Path, flags=None, csrc: Path = CSRC) -> subprocess.Popen:
    """Start nvcc on ``<csrc>/<name>.cu`` into the library ``out``, with
    ``flags`` in place of the source's own (``SOURCE_FLAGS``); its output and
    errors in one text pipe."""
    flags = SOURCE_FLAGS.get(name, ()) if flags is None else flags
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-I", str(csrc), "-o", str(out), str(Path(csrc) / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built for the current sources;
    return {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    key = _source_hash()
    out = {src.stem: BUILD_DIR / f"{src.stem}-{key}.so" for src in sorted(CSRC.glob("*.cu"))}
    todo = {name: lib for name, lib in out.items() if not lib.exists()}
    if not todo:
        return out
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        procs[name] = (tmp, start_nvcc(name, tmp))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        todo[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def open_library(name: str, path) -> ctypes.CDLL:
    """The library at ``path``, a build of ``csrc/<name>.cu``, its exported
    functions typed from ``SIGNATURES[name]``."""
    lib = ctypes.CDLL(str(path))
    for fn, sig in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype, f.argtypes = _CTYPES[sig[0]], [_CTYPES[c] for c in sig[2:-1]]
    return lib


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    if name not in _loaded:
        _loaded[name] = open_library(name, build()[name])
    return _loaded[name]


@contextlib.contextmanager
def swapped(name: str, path):
    """Run the block with the library at ``path`` (another build of
    ``csrc/<name>.cu``) loaded in place of ``load(name)``'s; the previous one
    is back on exit, whatever the block raised.  Yields the library."""
    before = _loaded.get(name)
    _loaded[name] = lib = open_library(name, path)
    try:
        yield lib
    finally:
        if before is None:
            _loaded.pop(name, None)
        else:
            _loaded[name] = before


def check_launch(name: str, err: int, what: str) -> None:
    """Raise if a launcher of library ``name`` returned a CUDA error."""
    if err != 0:
        msg = getattr(load(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def check_tensors(what: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous float32 CUDA tensors; raise on anything else."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: the kernel takes CUDA tensors, got one on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: the kernel runs in float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors")
