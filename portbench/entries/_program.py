"""The program's counter registry (``runtime.profiling.counters``), for the
readers of its spans and counters: a snapshot of every counter, or None
where the program has no registry."""

from __future__ import annotations


def counters():
    try:
        from distantspeech_tpu_torch.runtime.profiling import counters
    except ImportError:
        return None
    return counters()
