"""The entry point of ``respeaker4_full_stack``: ``full_stack_process`` of
the program, as a user calls it, on the configuration file's settings."""

from __future__ import annotations

import numpy as np


def load(cfg: dict, device):
    """A callable {"x": [B, M, S], "far": [B, S]} -> {"enhanced": [B, S'],
    "kws": [B, S'], "p": [B, T, F]} on ``device``."""
    from distantspeech_tpu_torch.adaptive.aec import AecConfig
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, full_stack_process

    arr, a = cfg["array"], cfg["aec"]
    fcfg = FullStackConfig(n_mics=arr["n_mics"], frame_len=cfg["frame_len"],
                           aec=AecConfig(filter_len=a["filter_len"], num_block=a["num_block"], alpha=a["alpha"],
                                         gamma=a["gamma"], mu_max=a["mu_max"], fs=arr["fs"]),
                           postfilter=True)
    _hold(fcfg, cfg)
    geom = ArrayGeometry.circular(arr["n_mics"], arr["radius_m"], fs=arr["fs"], c=arr["sound_speed"])
    look = tuple(np.deg2rad(cfg["look_deg"]))

    def call(batch: dict) -> dict:
        out, kws, p = full_stack_process(batch["x"], batch["far"], geom, look, fcfg, backend=cfg["backend"],
                                         device=device)
        return {"enhanced": out, "kws": kws, "p": p}

    return call


def _hold(fcfg, cfg: dict) -> None:
    """The constants the program does not take as settings, held to the
    configuration file's."""
    g, k, om = fcfg.gsc, fcfg.kws, fcfg.gsc.omlsa
    pairs = [
        ("gsc mu", g.aic.mu, cfg["gsc"]["mu"]), ("gsc alpha", g.aic.alpha, cfg["gsc"]["alpha"]),
        ("gsc fir_truncate", g.fir_truncate, cfg["gsc"]["fir_truncate"]),
        ("gsc vad_guard", g.vad_guard, cfg["gsc"]["vad_guard"]),
        ("kws mu", k.mu, cfg["kws"]["mu"]), ("kws alpha", k.alpha, cfg["kws"]["alpha"]),
        ("kws defer_seconds", k.defer_seconds, cfg["kws"]["defer_seconds"]),
        ("mcra L", g.mcra.L, cfg["mcra"]["L"]), ("omlsa mcra L", om.mcra.L, cfg["omlsa"]["mcra"]["L"]),
    ]
    for key in ("alpha_s", "alpha_d", "alpha_p", "delta_s", "p_max", "p_min"):
        pairs += [(f"mcra {key}", getattr(g.mcra, key), cfg["mcra"][key]),
                  (f"omlsa mcra {key}", getattr(om.mcra, key), cfg["omlsa"]["mcra"][key])]
    for key in ("alpha_s", "alpha_d", "alpha_xi", "beta", "Bmin", "eps_tbrr", "gamma_high", "gamma_low",
                "omega_high", "omega_low", "q_min", "q_max", "gmin_db"):
        pairs.append((f"omlsa {key}", getattr(om, key), cfg["omlsa"][key]))
    for name, have, want in pairs:
        if have != want:
            raise ValueError(f"the program's {name} = {have}, the configuration states {want}")
