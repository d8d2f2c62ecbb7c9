"""Command-line entry point: enhance multichannel audio with any pipeline.

Counterpart of ``distantspeech_tpu/runtime/cli.py``:

    python -m distantspeech_tpu_torch.runtime.cli input.wav output.wav \
        --pipeline mvdr --mics 4 --array linear --angle 90 [--cpu]

Pipelines: fixed (DS/SD), mvdr, enhance (MVDR+OM-LSA), pmwf, gsc, gsc_time,
tdgsc, fdgsc, subband_gsc, dios_gsc, mccowan (DS + postfilter), wpe, kws,
binaural, and with ``--stream`` the full stack.  JAX's parser lacks the
``full_stack`` choice that its ``--stream`` branch handles; the port adds it.
The audio runs on the CUDA card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="distantspeech_tpu_torch enhancement CLI")
    p.add_argument("input", help="input wav (multichannel) or directory of per-channel wavs")
    p.add_argument("output", help="output wav path")
    p.add_argument("--pipeline", default="enhance",
                   choices=["fixed_ds", "fixed_sd", "mvdr", "enhance", "pmwf", "gsc", "gsc_time",
                            "tdgsc", "fdgsc", "subband_gsc", "dios_gsc", "mccowan", "wpe", "kws",
                            "binaural", "full_stack"],
                   help="full_stack runs with --stream only: the last input channel is the far end")
    p.add_argument("--array", default="linear", choices=["linear", "circular"])
    p.add_argument("--mics", type=int, default=None, help="number of mics (default: all channels)")
    p.add_argument("--spacing", type=float, default=0.032, help="spacing / radius in metres")
    p.add_argument("--angle", type=float, default=90.0, help="look azimuth in degrees")
    p.add_argument("--frame-len", type=int, default=256)
    p.add_argument("--fs", type=int, default=16000)
    p.add_argument("--stream", action="store_true",
                   help="process chunk-by-chunk through the realtime streaming driver "
                        "instead of offline; writes a chunk-latency JSON report next to the output")
    p.add_argument("--chunk", type=int, default=1024,
                   help="samples per streaming chunk (reference uses 1024)")
    p.add_argument("--latency-json", default=None,
                   help="path for the --stream latency report (default: <output>.latency.json)")
    p.add_argument("--reference-exact", action="store_true",
                   help="use the reference-faithful (parity-tested) configuration instead of "
                        "the production-robust defaults; currently affects --pipeline gsc, "
                        "whose default enables normalize_aic and spp_rel_diag=1e-5 to guard "
                        "the complex64 path against non-finite weights")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    return p


def run(args) -> np.ndarray:
    import os

    import torch

    from distantspeech_tpu_torch._device import resolve_device
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.runtime.io import load_audio, load_wav_dir, save_audio

    dev = resolve_device("cpu" if args.cpu else None)
    if os.path.isdir(args.input):
        x, fs = load_wav_dir(args.input)
    else:
        x = load_audio(args.input)
        if x.ndim == 2:
            x = x.T  # [C, S]
        else:
            x = x[None, :]
        fs = args.fs
    M = args.mics or x.shape[0]
    x = np.ascontiguousarray(x[:M], dtype=np.float32)

    mk = ArrayGeometry.linear if args.array == "linear" else ArrayGeometry.circular
    geom = mk(M, args.spacing, fs=fs)
    angle = (args.angle, 0.0)
    angle_rad = (args.angle / 180.0 * np.pi, 0.0)

    if args.stream:
        import json

        from distantspeech_tpu_torch.runtime.streaming import STREAM_FACTORIES, wav_chunks

        factory = STREAM_FACTORIES.get(args.pipeline)
        if factory is None:
            raise SystemExit(
                f"--stream supports pipelines {sorted(STREAM_FACTORIES)} "
                f"(got {args.pipeline}); the offline mode covers the rest"
            )
        sgeom = geom
        if args.pipeline == "full_stack":
            # chunk convention: rows 0..M-2 are mics, the LAST row is the
            # far-end playback reference (make_full_stack_stream)
            if M < 3:
                raise SystemExit("--stream full_stack needs >= 2 mic channels + 1 far-end channel")
            sgeom = mk(M - 1, args.spacing, fs=fs)
        kwargs = {}
        if args.pipeline == "gsc" and args.reference_exact:
            from distantspeech_tpu_torch.beamform import GscConfig

            kwargs["cfg"] = GscConfig(n_mics=M, frame_len=args.frame_len)
        # zero-pad the tail to a whole chunk so no input is dropped; trim after
        S = x.shape[-1]
        pad = (-S) % args.chunk
        xp = np.pad(x, [(0, 0), (0, pad)]) if pad else x
        proc = factory(sgeom, angle, chunk_size=args.chunk, fs=fs, device=dev, **kwargs)
        y = proc.run(wav_chunks(xp, args.chunk))[..., :S]
        report = proc.latency_report()
        lat_path = args.latency_json or (args.output + ".latency.json")
        with open(lat_path, "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps(report))
        save_audio(args.output, y / max(np.max(np.abs(y)), 1e-9) * 0.9, fs=fs)
        return y

    if args.pipeline == "full_stack":
        raise SystemExit("--pipeline full_stack runs with --stream only (offline: full_stack_process)")
    xj = torch.as_tensor(x, device=dev)

    if args.pipeline in ("fixed_ds", "fixed_sd"):
        from distantspeech_tpu_torch.beamform import FixedBeamformerConfig, fixed_beamformer_weights, fixed_process

        cfg = FixedBeamformerConfig(weight_type="DS" if args.pipeline == "fixed_ds" else "SD")
        W = fixed_beamformer_weights(geom, angle, cfg)
        y = fixed_process(xj, W, cfg.stft, device=dev)
    elif args.pipeline == "mvdr":
        from distantspeech_tpu_torch.beamform import mvdr_process

        y = mvdr_process(xj, geom, angle, device=dev)
    elif args.pipeline == "enhance":
        from distantspeech_tpu_torch.beamform.enhance import enhance_process

        y = enhance_process(xj, geom, angle, device=dev)
    elif args.pipeline == "gsc":
        from distantspeech_tpu_torch.beamform import GscConfig, gsc_process

        # default: production-robust settings; --reference-exact restores the
        # parity-tested configuration (an unnormalised canceller and an
        # absolutely-loaded SPP inverse, both of which can go non-finite in
        # complex64 on loud or coherent input)
        if args.reference_exact:
            cfg = GscConfig(n_mics=M, frame_len=args.frame_len)
        else:
            cfg = GscConfig(n_mics=M, frame_len=args.frame_len, normalize_aic=True, spp_rel_diag=1e-5)
        y = gsc_process(xj, geom, angle_rad, cfg, device=dev)
    elif args.pipeline == "gsc_time":
        from distantspeech_tpu_torch.beamform import gsc_process_time

        y = gsc_process_time(xj, geom, angle_rad, frame_len=args.frame_len, device=dev)
    elif args.pipeline == "tdgsc":
        from distantspeech_tpu_torch.beamform import TdGscConfig, tdgsc_process

        y, _, _ = tdgsc_process(xj, geom, angle_rad, TdGscConfig(n_mics=M, frame_len=args.frame_len), device=dev)
    elif args.pipeline == "fdgsc":
        from distantspeech_tpu_torch.beamform import FdGscConfig, fdgsc_process

        y, _, _ = fdgsc_process(xj, geom, angle_rad, FdGscConfig(n_mics=M, frame_len=args.frame_len), device=dev)
    elif args.pipeline == "subband_gsc":
        from distantspeech_tpu_torch.beamform import SubbandGscConfig, subband_gsc_process

        y, _, _ = subband_gsc_process(xj, geom, angle_rad, SubbandGscConfig(n_mics=M, frame_len=args.frame_len),
                                      device=dev)
    elif args.pipeline == "pmwf":
        from distantspeech_tpu_torch.beamform import PmwfConfig, pmwf_process

        y = pmwf_process(xj, geom, PmwfConfig(n_mics=M, frame_len=args.frame_len), device=dev)
    elif args.pipeline == "dios_gsc":
        from distantspeech_tpu_torch.array.alignment import time_alignment_filters
        from distantspeech_tpu_torch.beamform import DiosGscConfig, dios_gsc_process

        coeffs = time_alignment_filters(geom, angle_rad)  # [M, K]
        y, _ = dios_gsc_process(xj, coeffs.astype(np.float32), DiosGscConfig(n_mics=M), device=dev)
    elif args.pipeline == "mccowan":
        from distantspeech_tpu_torch.beamform import FixedBeamformerConfig, fixed_beamformer_weights, fixed_process
        from distantspeech_tpu_torch.postfilter import McCowanConfig, mccowan_process

        fcfg = FixedBeamformerConfig(weight_type="DS")
        W = fixed_beamformer_weights(geom, angle, fcfg)
        ds = fixed_process(xj, W, fcfg.stft, device=dev)
        y = mccowan_process(xj, ds, geom, McCowanConfig(n_fft=args.frame_len, n_mics=M), device=dev)
    elif args.pipeline == "wpe":
        from distantspeech_tpu_torch.derev import WpeConfig, wpe_process

        y = wpe_process(xj, WpeConfig(n_channels=M), device=dev)
    elif args.pipeline == "kws":
        from distantspeech_tpu_torch.kws import DualMicKwsConfig, kws_process

        y = kws_process(xj[:2], DualMicKwsConfig(frame_len=args.frame_len), device=dev)
    elif args.pipeline == "binaural":
        from distantspeech_tpu_torch.coherence.enhance import BinauralConfig, binaural_process

        y, _ = binaural_process(xj[:2], geom, BinauralConfig(n_fft=args.frame_len), device=dev)
    else:  # pragma: no cover
        raise ValueError(args.pipeline)

    y = y.cpu().numpy()
    save_audio(args.output, y / max(np.max(np.abs(y)), 1e-9) * 0.9, fs=fs)
    return y


def main():  # pragma: no cover - thin wrapper
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
