"""The float32 bars of ``chip_smoke.py`` phase 17 and where they come from.

For each of the rows B8 (``binaural_process``), B9 (DS ``fixed_process`` ->
``mccowan_process``) and B10 (``dios_gsc_process``), on the bar's input
(``chip_smoke.slice_f_bar_input``: B=2 utterances x 1 s of seed-0 standard
normal float32 noise, as the JAX benchmark draws its inputs), this measures
JAX's own float32-vs-float64 gap, max |f32 - f64| / max |f64|, on the CPU
and checks it against the value written in ``chip_smoke.SLICE_F_JAX_GAP``
(within a factor of 2: a maximum of rounding differences moves with the
vector width XLA compiles for); and it holds the port's float32 on the CPU, against the port's
float64 on the same input, to the bar the card is held to, ``SLICE_F_MARGIN``
times JAX's gap (two float32 orderings of one recursion sit at about the
same distance from float64, not at the same point)."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.alignment import time_alignment_filters as j_align
from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.beamform import dios_gsc as jd, fixed as jfixed
from distantspeech_tpu.coherence import enhance as jenh
from distantspeech_tpu.postfilter import mccowan as jmc

_spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _jax_row(name):
    g2, g4 = JGeometry.linear(2, 0.032), JGeometry.linear(4, 0.032)
    if name == "B8":
        return lambda x: jenh.binaural_process(x, g2, jenh.BinauralConfig())[0]
    if name == "B9":
        fcfg = jfixed.FixedBeamformerConfig(weight_type="DS")
        W = jnp.asarray(jfixed.fixed_beamformer_weights(g4, (90.0, 0.0), fcfg))
        return lambda x: jmc.mccowan_process(x, jfixed.fixed_process(x, W, fcfg.stft), g4, jmc.McCowanConfig(n_mics=4))
    coeffs = np.asarray(j_align(g4, (np.pi / 2, 0.0)), dtype=np.float32)
    return lambda x: jd.dios_gsc_process(x, jnp.asarray(coeffs, dtype=x.dtype), jd.DiosGscConfig(n_mics=4))[0]


def _gap(f32, f64):
    f32, f64 = np.asarray(f32, np.float64), np.asarray(f64)
    return float(np.max(np.abs(f32 - f64)) / np.max(np.abs(f64)))


@pytest.mark.parametrize("name", ["B8", "B9", "B10"])
def test_slice_f_bar(name):
    x = cs.slice_f_bar_input(name)
    jrow = _jax_row(name)
    jgap = _gap(jrow(jnp.asarray(x)), jrow(jnp.asarray(x.astype(np.float64))))
    assert cs.SLICE_F_JAX_GAP[name] / 2 <= jgap <= 2 * cs.SLICE_F_JAX_GAP[name], jgap
    trow = cs.slice_f_rows(torch.device("cpu"))[name][2]
    tgap = _gap(trow(torch.as_tensor(x)), trow(torch.as_tensor(x.astype(np.float64))))
    assert tgap <= cs.SLICE_F_MARGIN * cs.SLICE_F_JAX_GAP[name], (tgap, jgap)
