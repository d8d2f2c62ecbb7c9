"""Simulated-scene MVDR+OM-LSA demo.

Builds a reverberant 8-mic scene with the image-source simulator, enhances
it with the flagship pipeline, and reports SI-SDR + realtime factor.

    python examples_torch/run_mvdr_simulated.py [--save out.wav] [--cpu]
"""

import argparse
import time

import numpy as np

from _common import device_args, host


def main(args):
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform import FixedBeamformerConfig, fixed_beamformer_weights, fixed_process
    from distantspeech_tpu_torch.beamform.enhance import enhance_process
    from distantspeech_tpu_torch.runtime.io import save_audio
    from distantspeech_tpu_torch.sim import RoomConfig, generate_scene

    fs, dur = 16000, 4
    rng = np.random.default_rng(0)
    t = np.arange(fs * dur) / fs
    env = (np.sin(2 * np.pi * 0.6 * t + 0.7) > -0.2).astype(float)
    env[: fs] = 0.0
    k = np.hanning(9)
    src = np.convolve(rng.standard_normal(fs * dur), k / k.sum(), "same") * env

    geom = ArrayGeometry.linear(8, 0.04, fs=fs)
    mix = generate_scene(
        src, geom.mic_loc, interference=rng.standard_normal(fs * dur),
        source_angle=90.0, source_distance=2.5, interf_angle=20.0,
        interf_distance=2.5, snr=25.0, sir=10.0,
        cfg=RoomConfig(max_order=1), seed=1,
    ).astype(np.float32)

    t0 = time.perf_counter()
    y = host(enhance_process(mix, geom, (90.0, 0.0), device=args.device))
    elapsed = time.perf_counter() - t0
    ds_cfg = FixedBeamformerConfig(weight_type="DS")
    W = fixed_beamformer_weights(geom, (90.0, 0.0), ds_cfg)
    y_ds = host(fixed_process(mix, W, ds_cfg.stft, device=args.device))

    def si_sdr(est, ref):
        n = min(len(est), len(ref))
        est, ref = est[:n] - est[:n].mean(), ref[:n] - ref[:n].mean()
        a = np.dot(est, ref) / np.dot(ref, ref)
        return 10 * np.log10(np.sum((a * ref) ** 2) / np.sum((est - a * ref) ** 2))

    def best(sig):
        return max(si_sdr(sig[l:], src[: len(src) - l]) for l in range(0, 400))

    print(f"SI-SDR: input {best(mix[0]):.2f} dB | DS {best(y_ds):.2f} dB | "
          f"MVDR+OMLSA {best(y):.2f} dB")
    print("(adaptive MVDR trades SI-SDR for noise suppression under array "
          "mismatch -- same behaviour as the reference implementation)")
    print(f"processed {dur}s of 8-mic audio in {elapsed:.2f}s on {args.device}")

    if args.save:
        save_audio(args.save, y / np.max(np.abs(y)) * 0.9, fs=fs)
        print(f"wrote {args.save}")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--save", default=None)
    main(device_args(p))
