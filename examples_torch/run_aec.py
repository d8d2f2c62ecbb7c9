"""Acoustic echo cancellation demo: speex-style MDF AEC with two-path
transfer logic, stepped over blocks, reporting echo-return-loss enhancement
over time.

    python examples_torch/run_aec.py [--cpu]
"""

import numpy as np

from _common import demo_args


def main():
    args = demo_args(__doc__)
    import torch

    from distantspeech_tpu_torch.adaptive import AecConfig, aec_init, aec_step

    fs = 16000
    rng = np.random.default_rng(0)
    # continuous far-end signal (speech gaps halve the effective adaptation
    # time of the conservative speex-style optimal stepsize)
    k = np.hanning(9)
    far = np.convolve(rng.standard_normal(fs * 8), k / k.sum(), "same").astype(np.float32)
    rir = np.zeros(480)
    rir[100] = 0.7
    rir[200] = -0.4
    rir[330] = 0.2
    echo = np.convolve(far, rir)[: len(far)].astype(np.float32)
    near = 0.01 * rng.standard_normal(len(far)).astype(np.float32)
    mic = echo + near

    # num_block=1 (single-partition FLMS) converges to ~20 dB ERLE here;
    # more partitions lower latency but converge far slower with the
    # conservative per-bin optimal stepsize
    cfg = AecConfig(filter_len=512, num_block=1)
    B = cfg.block_len
    T = len(far) // B
    st = aec_init(cfg, device=args.device)

    # the block loop (the JAX package scans it): output energy per block
    xs = torch.as_tensor(far[: T * B].reshape(T, B), device=args.device)
    ds = torch.as_tensor(mic[: T * B].reshape(T, B), device=args.device)
    out_e = []
    for x, d in zip(xs, ds):
        st, (out, _) = aec_step(cfg, st, x, d)
        out_e.append(torch.sum(out**2))
    out_e = torch.stack(out_e).cpu().numpy()
    mic_e = (mic[: T * B].reshape(T, B) ** 2).sum(axis=1)

    for sec in range(0, 8, 2):
        sl = slice(sec * T // 8, (sec + 2) * T // 8)
        erle = 10 * np.log10(mic_e[sl].sum() / (out_e[sl].sum() + 1e-12))
        print(f"t = {sec}-{sec + 2}s: ERLE {erle:5.1f} dB")


if __name__ == "__main__":
    main()
