"""Fixed beamformer demo: DS and superdirective weights + array metrics.

Design weights once from the look direction, apply them to a 4-mic
mixture, and report SI-SDR and the white-noise gain / directivity index of
both designs.

    python examples_torch/run_fixedbeamformer.py [--wav in.wav] [--save out.wav] [--cpu]
"""

from _common import demo_args, host, load_or_make, maybe_save, si_sdr


def main():
    args = demo_args(__doc__)
    import numpy as np
    import torch

    from distantspeech_tpu_torch.beamform import FixedBeamformerConfig, fixed_beamformer_weights, fixed_process
    from distantspeech_tpu_torch.stats import wng_di

    mix, geom, src = load_or_make(args)
    look = (90.0, 0.0)
    outs = {}
    for wt in ("DS", "SD"):
        cfg = FixedBeamformerConfig(weight_type=wt)
        W = fixed_beamformer_weights(geom, look, cfg)
        outs[wt] = host(fixed_process(mix, W, cfg.stft, device=args.device))
        wng, di = wng_di(geom, torch.as_tensor(W, device=args.device), look, cfg.stft.n_fft)
        print(f"{wt}: mean WNG {float(wng.mean()):6.2f} dB | mean DI {float(di.mean()):5.2f} dB")

    if src is not None:
        print(f"SI-SDR: input {si_sdr(mix[0], src):.2f} dB | DS {si_sdr(outs['DS'], src):.2f} dB | "
              f"SD {si_sdr(outs['SD'], src):.2f} dB")
    maybe_save(args, outs["SD"])


if __name__ == "__main__":
    main()
