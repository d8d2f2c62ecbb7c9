"""Dual-mic KWS "Hotword Cleaner" demo: an FLMS adaptive noise canceller
whose filter coefficients are applied 1.5 s deferred by a second fixed
filter, so a keyword arriving later is never adapted on and survives the
cancellation.

Channel layout: channel 0 is the interference reference, channel 1 is the
primary mic carrying interference + keyword.

    python examples_torch/run_kws_cleaner.py [--cpu]
"""

import numpy as np

from _common import demo_args, host, speech_like


def main():
    args = demo_args(__doc__)
    from distantspeech_tpu_torch.kws import DualMicKwsConfig, kws_process

    fs = 16000
    rng = np.random.default_rng(0)
    S = fs * 6
    interf = rng.standard_normal(S).astype(np.float32)
    x0 = interf  # reference mic: interference only
    x1 = np.roll(interf, 3) * 0.9  # primary mic: delayed/attenuated interference
    kw = np.zeros(S, dtype=np.float32)  # keyword in the last 1.5 s
    k0 = S - fs * 3 // 2
    kw[k0:] = speech_like(fs, 1.5, seed=5)
    x1k = x1 + kw

    cfg = DualMicKwsConfig(frame_len=256, fs=fs)
    y = host(kws_process(np.stack([x0, x1k]), cfg, device=args.device))

    pre = slice(fs * 3, k0)  # converged, pre-keyword
    kwr = slice(k0 + fs // 4, S)  # keyword region
    supp = 10 * np.log10(np.mean(y[pre] ** 2) / np.mean(x1[pre] ** 2))
    keep = 10 * np.log10(np.mean(y[kwr] ** 2) / np.mean(kw[kwr] ** 2))
    print(f"interference suppression before the keyword: {supp:.1f} dB")
    print(f"keyword level through the deferred filter:   {keep:+.1f} dB")


if __name__ == "__main__":
    main()
