"""The port's boundary: no JAX and nothing of the JAX package in it, the card
as the default device with no quiet CPU fallback, and the timing helpers
refusing to time without a card."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distantspeech_tpu_torch import resolve_device
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.beamform import (
    GscConfig,
    PmwfConfig,
    adaptive_mvdr2_process,
    fixed_beamformer_weights,
    fixed_process,
    gsc_init,
    gsc_process,
    gsc_process_time,
    pmwf_process,
)
from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_process
from distantspeech_tpu_torch.beamform.fdgsc import FdGscConfig, fdgsc_process
from distantspeech_tpu_torch.beamform.mvdr import mvdr_process
from distantspeech_tpu_torch.beamform.subband_gsc import SubbandGscConfig, subband_gsc_process
from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig, tdgsc_process
from distantspeech_tpu_torch.derev import WpeConfig, wpe_init, wpe_process, wpe_run
from distantspeech_tpu_torch.doa import IdoaConfig, idoa_init, idoa_run, srp_process, wpe_srp_process
from distantspeech_tpu_torch.noise import McMcraConfig, Mcra2Config, mc_mcra_init, mcra2_init
from distantspeech_tpu_torch.transform import SubbandConfig, subband_synthesis_init
from distantspeech_tpu_torch.kws import kws_process
from distantspeech_tpu_torch.ops import cuda_aec as ca, cuda_enhance as ce, cuda_flms as cf, cuda_mvdr as cm
from distantspeech_tpu_torch.ops import cuda_mcra as cmc, cuda_sgsc as cs, cuda_srp as cr
from distantspeech_tpu_torch.runtime import profiling
from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, full_stack_process

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "distantspeech_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "scripts").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "distantspeech_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path.name} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, distantspeech_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'distantspeech_tpu_torch.'): importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'distantspeech_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_the_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((8, 1280), np.float32)
    geom = ArrayGeometry.linear(8, 0.032)
    x4, geom4 = x[:4], ArrayGeometry.linear(4, 0.032)
    for call in (
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: enhance_process(x, geom),
        lambda: enhance_process(x[None], geom, backend="mega"),
        lambda: enhance_process(x[None], geom, backend="pallas"),
        lambda: mvdr_process(x, geom),
        lambda: tdgsc_process(x[None], geom, cfg=TdGscConfig(n_mics=8), backend="fused"),
        lambda: full_stack_process(x4[None], x4[:1], geom4, cfg=FullStackConfig(n_mics=4), backend="fused"),
        lambda: full_stack_process(x4[None], x4[:1], geom4, cfg=FullStackConfig(n_mics=4)),
        lambda: fdgsc_process(x4[None], geom4, cfg=FdGscConfig(n_mics=4), backend="fused"),
        lambda: fdgsc_process(x4[None], geom4, cfg=FdGscConfig(n_mics=4)),
        lambda: kws_process(x[:2]),
        lambda: cf.fused_tdgsc(x4[None], geom4, cfg=TdGscConfig(n_mics=4)),
        lambda: ca.fused_aec(x4[:1], x4[None]),
        lambda: cf.fused_kws(x[None, :2]),
        lambda: cf.fused_fdgsc(x4[None], geom4, cfg=FdGscConfig(n_mics=4)),
        lambda: subband_gsc_process(x4[None], geom4, cfg=SubbandGscConfig(n_mics=4)),
        lambda: subband_gsc_process(x4[None], geom4, cfg=SubbandGscConfig(n_mics=4), backend="fused"),
        lambda: cs.fused_subband_gsc(x4[None], geom4),
        lambda: srp_process(x, geom),
        lambda: srp_process(x, geom, backend="fused"),
        lambda: cr.fused_srp_spectrum(np.zeros((3, 129, 8), np.complex64), np.ones((360, 129, 8), np.complex64)),
        lambda: fixed_process(x4, fixed_beamformer_weights(geom4, (90.0, 0.0)), EnhanceConfig().mvdr.stft),
        lambda: adaptive_mvdr2_process(x4, np.ones((129, 4), np.complex64)),
        lambda: gsc_process(x4[None], geom4, cfg=GscConfig(n_mics=4)),
        lambda: gsc_process_time(x4[None], geom4),
        lambda: pmwf_process(x4[None], geom4, PmwfConfig(n_mics=4)),
        lambda: pmwf_process(x4[None], geom4, PmwfConfig(n_mics=4, full=False)),
        lambda: wpe_process(x[:2], WpeConfig(num_bands=64, hop=16)),
        lambda: wpe_run(WpeConfig(num_bands=64, hop=16), np.zeros((6, 33, 2), np.complex64)),
        lambda: idoa_run(IdoaConfig(n_fft=256), geom4, np.zeros((3, 129, 4), np.complex64)),
        lambda: wpe_srp_process(x[None], geom),
        lambda: wpe_srp_process(x[None], geom, backend="fused"),
        lambda: wpe_init(WpeConfig()),
        lambda: gsc_init(GscConfig()),
        lambda: mc_mcra_init(McMcraConfig()),
        lambda: mcra2_init(Mcra2Config()),
        lambda: idoa_init(IdoaConfig(), 4),
        lambda: subband_synthesis_init((), SubbandConfig()),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_leave_launches_at_zero():
    for mod in (ca, ce, cf, cm, cmc, cs, cr):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    x = np.random.default_rng(0).standard_normal((1, 2, 128 * 6)).astype(np.float32)
    geom = ArrayGeometry.linear(2, 0.032)
    for backend in ("scan", "pallas", "fused", "mega"):
        y = enhance_process(x, geom, cfg=EnhanceConfig(), backend=backend, device="cpu")
        assert y.shape == (1, 128 * 6) and bool(torch.isfinite(y).all())
    for postfilter in (False, True):
        y, p, bm = tdgsc_process(x, geom, (np.pi / 2, 0.0), TdGscConfig(n_mics=2, frame_len=128, postfilter=postfilter),
                                 backend="fused", device="cpu")
        assert y.shape == (1, 128 * 6) and p.shape == (1, 6, 129) and bool(torch.isfinite(y).all())
    x4 = np.random.default_rng(1).standard_normal((1, 4, 256 * 6)).astype(np.float32)
    geom4 = ArrayGeometry.linear(4, 0.032)
    y, kws, p = full_stack_process(x4, x4[:, 0], geom4, (np.pi / 2, 0.0), FullStackConfig(n_mics=4), backend="fused",
                                   device="cpu")
    assert y.shape == kws.shape == (1, 256 * 6) and p.shape == (1, 6, 257) and bool(torch.isfinite(y).all())
    y, p, bm = fdgsc_process(x4, geom4, (np.pi / 2, 0.0), FdGscConfig(n_mics=4), backend="fused", device="cpu")
    assert y.shape == (1, 256 * 6) and bm.shape == (1, 4, 256 * 6) and bool(torch.isfinite(y).all())
    y, p, bm = subband_gsc_process(x4, geom4, (np.pi / 2, 0.0), SubbandGscConfig(n_mics=4), backend="fused", device="cpu")
    assert y.shape == (1, 256 * 6) and p.shape == (1, 6, 257) and bool(torch.isfinite(y).all())
    spec, p = srp_process(x4, geom4, backend="fused", device="cpu")
    assert spec.shape == (1, 12, 360) and p.shape == (1, 12, 129) and bool(torch.isfinite(spec).all())
    assert cs.LAUNCHES == {"fused_subband_gsc": 0} and cr.LAUNCHES == {"fused_srp_spectrum": 0}
    assert ce.LAUNCHES == {"fused_enhance": 0, "fused_enhance_full": 0} and cm.LAUNCHES == {"fused_mvdr_scan": 0}
    assert cf.LAUNCHES == {"fused_tdgsc": 0, "fused_kws": 0, "fused_fdgsc": 0} and ca.LAUNCHES == {"fused_aec": 0}
    assert cmc.LAUNCHES == {"mcra_run": 0}  # the pallas and SRP paths' MCRA ran as the plain version


def test_timing_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiling.benchmark(lambda: None)
    per, retries = profiling.slope_per_iter(lambda n: 0.5 + 0.01 * n)
    assert retries == 0 and abs(per - 0.01) < 1e-12
    with pytest.raises(profiling.TimingError):
        profiling.slope_per_iter(lambda n: 1.0 - 0.01 * n, retries=1)
