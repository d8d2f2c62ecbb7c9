"""Adaptive WPE dereverberation demo.

Subband multichannel RLS-WPE on a 2-channel scene with synthetic exponential
reverb tails; reports the late-reverb residual energy before/after (the
prediction delay keeps the direct path, the linear predictor removes the
tail).

    python examples_torch/run_wpe.py [--wav in.wav] [--save out.wav] [--cpu]
"""

import numpy as np

from _common import demo_args, host, load_or_make, maybe_save


def main():
    args = demo_args(__doc__)
    from distantspeech_tpu_torch.derev import WpeConfig, wpe_process

    if args.wav:
        mix, geom, _ = load_or_make(args)
        cfg = WpeConfig(n_channels=mix.shape[0])
        y = host(wpe_process(mix, cfg, device=args.device))
        print(f"WPE out RMS {float(np.sqrt(np.mean(y ** 2))):.4f}")
        maybe_save(args, y)
        return

    cfg = WpeConfig(num_bands=64, hop=32, n_channels=2, filter_len=3, delay=1)
    rng = np.random.default_rng(9)
    S = 32 * 800
    dry = rng.standard_normal(S) * (rng.uniform(size=S) > 0.6)
    wet = []
    for _ in range(2):
        rir = rng.standard_normal(400) * np.exp(-np.arange(400) / 60.0)
        rir[0] = 1.0
        wet.append(np.convolve(dry, rir)[:S])
    wet = np.stack(wet).astype(np.float32)

    out = host(wpe_process(wet, cfg, device=args.device))

    # score the post-convergence half; the subband round-trip delays by
    # win_len - hop samples
    n0 = S // 2
    d = cfg.subband.win_len - cfg.hop
    resid_in = np.sum((wet[0][n0:] - dry[n0:]) ** 2)
    est = out[n0 + d : S]
    est = est / np.max(np.abs(est)) * np.max(np.abs(dry))
    resid_out = np.sum((est - dry[n0 : S - d]) ** 2)
    print(f"late-reverb residual: {10 * np.log10(resid_in / resid_out):.1f} dB improvement "
          f"(in {resid_in:.0f} -> out {resid_out:.0f})")
    maybe_save(args, out)


if __name__ == "__main__":
    main()
