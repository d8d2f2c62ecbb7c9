#!/usr/bin/env python3
"""Time every stream factory chunk by chunk on the card, in one tree.

    python3 scripts/stream_times.py [--root DIR]

``--root`` is the checkout whose ``distantspeech_tpu_torch`` is imported
(default: the one holding this script; it must have
``runtime/streaming.py``), so that two versions of the port can be timed in
turns, each in its own process.  The protocol is ``chip_smoke.py`` phase
18's (this script's tree): an 8-mic linear array at 0.032 m (7 mics and the
far end for the full stack), 60 chunks of 1,024 samples at 16 kHz of seed-0
standard normal x 0.1, the report without the 2 warm chunks; then the
identity step's transport floor.  Prints one JSON line: {"root", "card",
"streams": {name: latency report + torch calls and host synchronisations a
steady chunk}}.  Paired timing of two trees, in turns:

    python3 scripts/stream_times.py --root PARENT; python3 scripts/stream_times.py; ...
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_protocol", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from distantspeech_tpu_torch.runtime.streaming import STREAM_FACTORIES, StreamingProcessor, wav_chunks

    if not torch.cuda.is_available():
        print("stream_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    x = (np.random.default_rng(0).standard_normal((cs.STREAM_MICS, cs.STREAM_CHUNK * cs.STREAM_CHUNKS)) * 0.1).astype(
        np.float32)
    chunks = list(wav_chunks(x, cs.STREAM_CHUNK))
    reports = {}
    for name in sorted(STREAM_FACTORIES):
        proc = STREAM_FACTORIES[name](cs.stream_geometry(name), (90.0, 0.0), chunk_size=cs.STREAM_CHUNK, fs=cs.FS,
                                      device=dev)
        out = proc.run(chunks)
        if not np.isfinite(out).all():
            raise RuntimeError(f"stream_times: non-finite {name} stream")
        syncs, _ = cs.host_syncs(proc, chunks[0])
        reports[name] = {**proc.latency_report(skip_warmup=cs.STREAM_WARMUP),
                         "torch_calls_a_chunk": cs.torch_calls(proc.step, proc.state, torch.as_tensor(chunks[0],
                                                                                                   device=dev)),
                         "host_syncs_a_chunk": syncs}
    ident = StreamingProcessor(lambda s, c: (s, c.mean(dim=0)), (), chunk_size=cs.STREAM_CHUNK, fs=cs.FS, device=dev)
    ident.run(chunks)
    reports["_identity_floor"] = ident.latency_report(skip_warmup=cs.STREAM_WARMUP)
    print(json.dumps({"root": args.root, "card": cs.card_line(), "streams": reports}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
