"""The runtime: audio I/O, streaming, the full stack, checkpoints, the CLI,
plots and timing, with the JAX package's names.  The package's own names
(``load_audio``, ``StreamingProcessor``, ...) are imported on first use:
every kernel wrapper imports ``runtime.profiling``, and an eager import
here would load SciPy's audio reader and the stream processors with it."""

import importlib

_LAZY = dict.fromkeys(("find_files", "load_audio", "load_pcm", "load_wav_dir", "pcmread", "save_audio"), "io")
_LAZY["StreamingProcessor"] = "streaming"
__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
