"""Dual-mic coherence enhancement demo.

Estimated-vs-diffuse magnitude-squared-coherence gains on a 2-mic scene,
with the published gain rule selected by ``method`` (1-5).

These published rules are tuned for real binaural recordings in diffuse
fields; on synthetic scenes the short-window MSC estimate is biased high and
the gains are aggressive, as in the reference implementation.

    python examples_torch/run_binaural.py [--wav in.wav] [--save out.wav] [--cpu]
"""

import numpy as np

from _common import demo_args, host, load_or_make, maybe_save


def main():
    args = demo_args(__doc__)
    from distantspeech_tpu_torch.coherence.enhance import BinauralConfig, binaural_process

    mix, geom, src = load_or_make(args, n_mics=2, snr=5.0, sir=60.0)
    y = None
    for method in (1, 3):
        y, snr = binaural_process(mix, geom, BinauralConfig(method=method), device=args.device)
        y = host(y)
        if src is not None:
            n = min(len(y), len(src))
            env = np.convolve(np.abs(src), np.ones(512) / 512, "same")[:n]
            gap = env < 0.02 * env.max()
            act = env > 0.2 * env.max()
            gap[:16000] = act[:16000] = False
            sup = 10 * np.log10(np.mean(y[:n][gap] ** 2) / np.mean(mix[0][:n][gap] ** 2))
            keep = 10 * np.log10(np.mean(y[:n][act] ** 2) / np.mean(mix[0][:n][act] ** 2))
            print(f"method {method}: noise-gap change {sup:6.1f} dB | speech-region change {keep:6.1f} dB | "
                  f"mean est. SNR {float(snr.mean()):.2f}")
        else:
            print(f"method {method}: out RMS {float(np.sqrt(np.mean(y ** 2))):.4f}")
    maybe_save(args, y)


if __name__ == "__main__":
    main()
