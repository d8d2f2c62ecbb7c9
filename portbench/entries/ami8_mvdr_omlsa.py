"""The entry point of ``ami8_mvdr_omlsa``: ``enhance_process`` of the
program, as a user calls it, on the configuration file's settings."""

from __future__ import annotations


def load(cfg: dict, device):
    """A callable {"x": [B, M, S]} -> {"y": [B, S]} on ``device``."""
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_process
    from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig
    from distantspeech_tpu_torch.transform.stft import StftConfig

    arr, mv, mc = cfg["array"], cfg["mvdr"], cfg["mcra"]
    stft = StftConfig(cfg["stft"]["n_fft"], cfg["stft"]["hop"], cfg["stft"]["window"])
    ecfg = EnhanceConfig(
        mvdr=MvdrConfig(stft=stft, alpha_v=mv["alpha_v"], p_vad=mv["p_vad"], diag=mv["diag"],
                        rel_diag=mv["rel_diag"], mcra_L=mc["L"], vad_guard=mv["vad_guard"]),
        alpha_xi=cfg["omlsa"]["alpha_xi"], gmin=cfg["omlsa"]["gmin"],
    )
    held = ecfg.mvdr.mcra  # MCRA's constants are not settings of the program: hold them to the file's
    for key in ("alpha_s", "alpha_d", "alpha_p", "delta_s", "p_max", "p_min"):
        if getattr(held, key) != mc[key]:
            raise ValueError(f"the program's MCRA {key} = {getattr(held, key)}, the configuration states {mc[key]}")
    if list(held.b) != mc["b"]:
        raise ValueError(f"the program's MCRA smoothing {held.b}, the configuration states {mc['b']}")
    geom = ArrayGeometry.circular(arr["n_mics"], arr["radius_m"], fs=arr["fs"], c=arr["sound_speed"])
    look = tuple(cfg["look_deg"])

    def call(batch: dict) -> dict:
        return {"y": enhance_process(batch["x"], geom, look, ecfg, backend=cfg["backend"], inv_mode=cfg["inv_mode"],
                                     device=device, t_chunk=cfg["t_chunk"])}

    return call
