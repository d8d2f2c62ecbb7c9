"""DOA-free MVDR: PCA steering from the speech covariance (no geometry).

The propagation vector is estimated as the principal eigenvector of the
spatial covariance, the natural companion to MVDR when the look direction
is unknown.  This demo:

1. synthesizes a reverberant scene with a noise-only lead-in,
2. estimates Rvv from the lead-in and Ryy from the speech segment,
3. takes ``a = pca_steering(Ryy - Rvv)`` with phase correction,
4. beamforms with ``mvdr_weights(a, Rvv^-1)``: no angle ever supplied,
5. compares SI-SDR against the geometry-informed DS beamformer.

    python examples_torch/run_pca_mvdr.py [--save out.wav] [--cpu]
"""

import numpy as np

from _common import demo_args, host, load_or_make, si_sdr


def main():
    args = demo_args(__doc__.splitlines()[0])
    import torch

    from distantspeech_tpu_torch.beamform import FixedBeamformerConfig, fixed_beamformer_weights, fixed_process
    from distantspeech_tpu_torch.runtime.io import save_audio
    from distantspeech_tpu_torch.stats.linalg import gauss_jordan_inv
    from distantspeech_tpu_torch.stats.weights import mvdr_weights, pca_steering, phase_correction
    from distantspeech_tpu_torch.transform import StftConfig, analysis, synthesis

    fs = 16000
    mix, geom, src = load_or_make(args, n_mics=6, dur=4.0, snr=10.0, sir=8.0)
    # prepend a noise-only second so Rvv is identifiable without a VAD
    rng = np.random.default_rng(3)
    lead = (0.05 * rng.standard_normal((mix.shape[0], fs))).astype(np.float32)
    x = np.concatenate([lead, mix], axis=-1)

    scfg = StftConfig()
    X = analysis(torch.as_tensor(x, device=args.device), scfg)  # [M, T, F]
    Z = torch.movedim(X, 0, -1)  # [T, F, M]
    t_lead = fs // scfg.hop

    def cov(Zseg):
        return torch.mean(Zseg[..., :, None] * torch.conj(Zseg)[..., None, :], dim=0)

    Rvv = cov(Z[:t_lead])  # [F, M, M]
    Ryy = cov(Z[t_lead:])
    a = phase_correction(pca_steering(Ryy - Rvv))  # [F, M]: no geometry used

    M = x.shape[0]
    w = mvdr_weights(a, gauss_jordan_inv(Rvv + 1e-6 * torch.eye(M, dtype=Rvv.dtype, device=Rvv.device)))
    Y = torch.einsum("fm,tfm->tf", torch.conj(w), Z)
    y = host(synthesis(Y, scfg))[fs:]  # drop the lead-in

    ds_cfg = FixedBeamformerConfig(weight_type="DS")
    Wds = fixed_beamformer_weights(geom, (90.0, 0.0), ds_cfg)
    y_ds = host(fixed_process(mix, Wds, ds_cfg.stft, device=args.device))

    if src is not None:
        print(f"SI-SDR: input {si_sdr(mix[0], src):.2f} dB | "
              f"DS (geometry) {si_sdr(y_ds, src):.2f} dB | "
              f"PCA-MVDR (blind) {si_sdr(y, src):.2f} dB")
    if not np.isfinite(y).all():
        raise SystemExit("non-finite PCA-MVDR output")
    if args.save:
        save_audio(args.save, y / max(np.max(np.abs(y)), 1e-9) * 0.9, fs=fs)
        print(f"wrote {args.save}")


if __name__ == "__main__":
    main()
