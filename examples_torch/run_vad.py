"""MCRA speech-presence VAD demo: the library's own MCRA SPP, which also
gates every adaptive pipeline, as a voice-activity detector.

    python examples_torch/run_vad.py [--cpu]
"""

import numpy as np

from _common import demo_args, host, speech_like


def main():
    args = demo_args(__doc__)
    import torch

    from distantspeech_tpu_torch.noise import McraConfig, mcra_run
    from distantspeech_tpu_torch.transform import StftConfig, analysis

    fs = 16000
    rng = np.random.default_rng(0)
    x = speech_like(fs, 4.0) + 0.05 * rng.standard_normal(4 * fs).astype(np.float32)

    cfg = StftConfig(256, 128)
    X = analysis(torch.as_tensor(x, device=args.device), cfg)  # [T, F]
    power = X.abs() ** 2
    _, p = mcra_run(McraConfig(nfft=cfg.n_fft, L=65), power)
    frame_p = host(p.mean(dim=-1))
    # bins without speech energy keep p ~ 0, so the full-band mean saturates
    # well below 1 even during speech: 0.3 is the empirical midpoint
    vad = frame_p > 0.3

    # print a coarse segmentation timeline (10 frames per char)
    line = "".join("#" if np.mean(vad[i : i + 10]) > 0.5 else "." for i in range(0, len(vad), 10))
    print(f"speech-active frames: {int(vad.sum())}/{len(vad)}")
    print("timeline:", line)


if __name__ == "__main__":
    main()
