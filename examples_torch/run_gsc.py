"""GSC beamformer family demo: frequency GSC, TDGSC and robust FDGSC.

On one synthetic scene: the steering-based GSC with an SPP-gated NLMS
canceller and the MC-MCRA OM-LSA postfilter, the time-domain block GSC, the
Herbordt/Kellermann overlap-save robust GSC and the subband GSC.

Metrics: energy change in source-silence gaps (interference suppression) and
in speech-active regions (target preservation) relative to mic 0; the SPP-
gated pipelines are nonlinear, so waveform SI-SDR understates them.  The
full-band GSC's OM-LSA gain gates hard on synthetic free-field scenes (its
multichannel speech-presence statistics are tuned for real arrays); TDGSC is
the gentlest variant, as in the reference implementations.

    python examples_torch/run_gsc.py [--wav in.wav] [--save out.wav] [--cpu]
"""

import numpy as np

from _common import demo_args, host, load_or_make, maybe_save


def main():
    args = demo_args(__doc__)
    import torch

    from distantspeech_tpu_torch.beamform import (
        FdGscConfig, GscConfig, SubbandGscConfig, TdGscConfig, fdgsc_process,
        gsc_process, subband_gsc_process,
    )
    from distantspeech_tpu_torch.beamform.tdgsc import tdgsc_process

    mix, geom, src = load_or_make(args, n_mics=4, sir=5.0, snr=30.0)
    angle = (np.pi / 2, 0.0)
    x = torch.as_tensor(mix, device=args.device)
    dev = args.device

    outs = {
        "GSC   ": host(gsc_process(x, geom, angle, GscConfig(n_mics=4), device=dev)),
        "TDGSC ": host(tdgsc_process(x, geom, angle, TdGscConfig(n_mics=4), device=dev)[0]),
        # the guard: freeze the canceller on the raw S/Smin speech indicator
        # during the MCRA warmup (see TdGscConfig.vad_guard)
        "+guard": host(tdgsc_process(x, geom, angle, TdGscConfig(n_mics=4, vad_guard=True), device=dev)[0]),
        "FDGSC ": host(fdgsc_process(x, geom, angle, FdGscConfig(n_mics=4), device=dev)[0]),
        "SbGSC ": host(subband_gsc_process(x, geom, angle, SubbandGscConfig(n_mics=4), device=dev)[0]),
    }
    if src is not None:
        for name, y in outs.items():
            n = min(len(y), len(src))
            env = np.convolve(np.abs(src), np.ones(512) / 512, "same")[:n]
            gap = env < 0.02 * env.max()
            act = env > 0.2 * env.max()
            gap[:16000] = act[:16000] = False  # skip the convergence phase
            sup = 10 * np.log10(np.mean(y[:n][gap] ** 2) / np.mean(mix[0][:n][gap] ** 2))
            keep = 10 * np.log10(np.mean(y[:n][act] ** 2) / np.mean(mix[0][:n][act] ** 2))
            print(f"{name}: noise-gap suppression {sup:6.1f} dB | speech-region change {keep:6.1f} dB")
    else:
        for name, y in outs.items():
            print(f"{name}: out RMS {float(np.sqrt(np.mean(y ** 2))):.4f}")
    maybe_save(args, outs["TDGSC "])


if __name__ == "__main__":
    main()
