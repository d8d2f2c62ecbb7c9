"""SRP-PHAT direction-of-arrival demo: steered-response power over a
360-degree grid with MCRA-SPP weighting, on a scene with a known source
angle.

    python examples_torch/run_doa.py [--wav in.wav] [--cpu]
"""

import numpy as np

from _common import demo_args, host, load_or_make


def main():
    args = demo_args(__doc__)
    from distantspeech_tpu_torch.doa import SrpConfig
    from distantspeech_tpu_torch.doa.srp import srp_process

    true_angle = 70.0
    mix, geom, src = load_or_make(args, n_mics=4, source_angle=true_angle, sir=40.0)
    spec_t, p = srp_process(mix, geom, SrpConfig(), device=args.device)  # [T, Theta], [T, F]
    # SPP-weighted aggregation over frames (the angle spectrum accumulated
    # over speech-active frames)
    w = host(p.mean(dim=-1))[:, None]
    spectrum = np.sum(host(spec_t) * w, axis=0)
    est = float(np.argmax(spectrum))
    if src is not None:
        print(f"true source angle {true_angle:.0f} deg -> SRP-PHAT estimate {est:.0f} deg")
    else:
        print(f"SRP-PHAT estimate: {est:.0f} deg")
    top = np.argsort(spectrum)[-3:][::-1]
    print("top-3 peaks:", ", ".join(f"{int(i)}deg" for i in top))


if __name__ == "__main__":
    main()
