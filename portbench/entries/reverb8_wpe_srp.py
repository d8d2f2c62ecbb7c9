"""The entry point of ``reverb8_wpe_srp``: ``wpe_srp_process`` of the
program, as a user calls it, on the configuration file's settings, with
the dereverberated signals returned beside the spectrum and p."""

from __future__ import annotations


def load(cfg: dict, device):
    """A callable {"x": [B, M, S]} -> {"y": [B, M, S], "spectrum": [B, T, 360],
    "p": [B, T, F]} on ``device``."""
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.derev.wpe import WpeConfig
    from distantspeech_tpu_torch.doa.srp import SrpConfig
    from distantspeech_tpu_torch.doa.wpe_srp import wpe_srp_process

    arr, w, s = cfg["array"], cfg["wpe"], cfg["srp"]
    wcfg = WpeConfig(num_bands=w["num_bands"], hop=w["hop"], n_channels=w["n_channels"], filter_len=w["filter_len"],
                     delay=w["delay"], forgetting_factor=w["forgetting_factor"], alpha_var=w["alpha_var"],
                     p_init=w["p_init"])
    scfg = SrpConfig(n_fft=s["n_fft"], resolution=s["resolution_deg"])
    _hold(wcfg, scfg, cfg)
    geom = ArrayGeometry.circular(arr["n_mics"], arr["radius_m"], fs=arr["fs"], c=arr["sound_speed"])

    def call(batch: dict) -> dict:
        spec, p, y = wpe_srp_process(batch["x"], geom, wcfg, scfg, phat=s["phat"], backend=cfg["backend"],
                                     device=device, return_dereverb=True)
        return {"y": y, "spectrum": spec, "p": p}

    return call


def _hold(wcfg, scfg, cfg: dict) -> None:
    """The constants the program does not take as settings, held to the
    configuration file's."""
    s, mc = cfg["srp"], cfg["mcra"]
    pairs = [("subband m", wcfg.subband.m, cfg["wpe"]["m"]), ("srp hop", scfg.stft.hop, s["hop"]),
             ("srp window", scfg.stft.window_key, s["window"]), ("mcra L", scfg.mcra.L, mc["L"]),
             ("mcra b", list(scfg.mcra.b), mc["b"])]
    pairs += [(f"mcra {key}", getattr(scfg.mcra, key), mc[key])
              for key in ("alpha_s", "alpha_d", "alpha_p", "delta_s", "p_max", "p_min")]
    for name, have, want in pairs:
        if have != want:
            raise ValueError(f"the program's {name} = {have}, the configuration states {want}")
