"""McCowan/Zelinski postfilter demo: the DS fixed beamformer followed by the
coherence-model Wiener postfilter.

    python examples_torch/run_postfilter.py [--wav in.wav] [--save out.wav] [--cpu]
"""

from _common import demo_args, host, load_or_make, maybe_save, si_sdr


def main():
    args = demo_args(__doc__)
    import torch

    from distantspeech_tpu_torch.beamform import FixedBeamformerConfig, fixed_beamformer_weights, fixed_process
    from distantspeech_tpu_torch.postfilter import McCowanConfig, mccowan_process

    mix, geom, src = load_or_make(args, n_mics=4)
    cfg = FixedBeamformerConfig(weight_type="DS")
    W = fixed_beamformer_weights(geom, (90.0, 0.0), cfg)
    x = torch.as_tensor(mix, device=args.device)
    ds = fixed_process(x, W, cfg.stft, device=args.device)
    y = host(mccowan_process(x, ds, geom, McCowanConfig(n_mics=mix.shape[0]), device=args.device))

    if src is not None:
        print(f"SI-SDR: input {si_sdr(mix[0], src):.2f} dB | DS {si_sdr(ds, src):.2f} dB | "
              f"DS+McCowan {si_sdr(y, src):.2f} dB")
    maybe_save(args, y)


if __name__ == "__main__":
    main()
