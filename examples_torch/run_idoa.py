"""IDOA spatial speech-presence demo: per-bin instantaneous-DOA likelihoods
against a free-field RTF grid, a spatial SPP map over (frequency, angle).

    python examples_torch/run_idoa.py [--cpu]
"""

import numpy as np

from _common import demo_args, host, make_scene


def main():
    args = demo_args(__doc__)
    import torch

    from distantspeech_tpu_torch.doa import IdoaConfig, idoa_run
    from distantspeech_tpu_torch.transform import StftConfig, analysis

    true_angle = 60.0
    mix, geom, src = make_scene(n_mics=4, source_angle=true_angle, sir=40.0, snr=25.0)

    cfg = IdoaConfig(n_fft=512, n_theta=180)  # linear array: 180-degree grid
    X = analysis(torch.as_tensor(mix, device=args.device), StftConfig(cfg.n_fft, cfg.n_fft // 2))  # [M, T, F]
    Xt = torch.movedim(X, -2, 0).transpose(-1, -2)  # [T, F, M]
    p = host(idoa_run(cfg, geom, Xt))  # [T, F, Theta]

    # aggregate the spatial likelihood over frames and speech-band bins
    spec = p[:, 8:100].mean(axis=(0, 1))
    est = int(np.argmax(spec))
    print(f"true source angle {true_angle:.0f} deg -> IDOA spatial-likelihood peak {est} deg")
    top = np.argsort(spec)[-3:][::-1]
    print("top-3:", ", ".join(f"{int(i)}deg" for i in top))


if __name__ == "__main__":
    main()
