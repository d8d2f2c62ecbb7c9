"""Streaming (chunked) enhancement demo: the realtime processing path.

Drives the flagship MVDR+OM-LSA step chunk by chunk through the
StreamingProcessor (host chunks -> the step on the card), printing the
realtime factor and overflow count.

    python examples_torch/streaming_enhance.py [--cpu]
"""

import argparse

import numpy as np

from _common import device_args


def main(args):
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.runtime.streaming import make_enhance_stream, wav_chunks

    fs, C, chunk = 16000, 4, 1024
    geom = ArrayGeometry.linear(C, 0.04, fs=fs)
    proc = make_enhance_stream(geom, (90.0, 0.0), chunk_size=chunk, fs=fs, device=args.device)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((C, fs * 4)).astype(np.float32) * 0.1
    out = proc.run(wav_chunks(x, chunk))
    print(f"chunks: {proc.chunks}, overflows: {proc.overflows}, out: {out.shape}")
    print(proc.latency_report())


if __name__ == "__main__":
    main(device_args(argparse.ArgumentParser(description=__doc__)))
