"""Transform round-trip demo: STFT analysis/synthesis and the Nyquist(M)
subband filterbank, round-tripping a signal and reporting reconstruction
error.

    python examples_torch/run_transform.py [--cpu]
"""

import numpy as np

from _common import demo_args, host, speech_like


def main():
    args = demo_args(__doc__)
    import torch

    from distantspeech_tpu_torch.transform import (
        StftConfig, SubbandConfig, analysis, subband_analysis, subband_synthesis, synthesis,
    )

    x = speech_like(16000, 2.0)
    xt = torch.as_tensor(x, device=args.device)
    cfg = StftConfig(256, 128)
    X = analysis(xt, cfg)
    y = host(synthesis(X, cfg))
    n = min(len(x), len(y))
    # sqrt-Hann analysis+synthesis with hop = n_fft/2 is a perfect-
    # reconstruction pair up to the hop-sample latency
    err = np.max(np.abs(y[cfg.hop:n] - x[: n - cfg.hop]))
    print(f"STFT round-trip: {X.shape[-2]} frames x {X.shape[-1]} bins, max|err| = {err:.2e}")

    scfg = SubbandConfig()
    S = subband_analysis(xt, scfg)
    ys = host(subband_synthesis(S, scfg))
    print(f"Subband round-trip: {S.shape[-2]} frames x {S.shape[-1]} bands, "
          f"out RMS {float(np.sqrt(np.mean(ys ** 2))):.4f} (in {float(np.sqrt(np.mean(x ** 2))):.4f})")


if __name__ == "__main__":
    main()
