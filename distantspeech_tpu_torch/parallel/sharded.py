"""Sharded pipelines: utterance DP x frequency-bin model parallel.

Counterpart of ``distantspeech_tpu/parallel/sharded.py``.  JAX annotates
shardings and lets XLA insert the collectives; PyTorch has no such pass
over eager frame loops and hand-written kernels, so here each rank of the
mesh (one process a device, ``parallel.mesh``) runs the port's own steps,
wrappers and kernels on its block, and every exchange is an explicit,
recorded collective (``parallel._shard``).

Each runner keeps JAX's single-controller contract: ``run(x [B, M, S])``
takes the same global batch on every rank and returns the whole result on
every rank.  A rank takes its utterances along ``dp`` and, in the
bin-sharded runners, its bins along ``fb``:

- the bins pad up to a multiple of ``fb`` and each rank works on its own
  plus a halo of input bins (one each side for MCRA's 3-tap smoothing, two
  below for the MC-MCRA gain's zeroed first bins) taken from its own
  analysis, so no exchange is needed before the frame loop; the halo's
  outputs are dropped;
- MCRA's edge bins (bin 0 and bin F - 1) are global bins: a rank runs the
  step with a config whose ``half_bin`` is its working range, whose first
  and last bins are either the global edges or halo bins;
- the bins are gathered over ``fb`` before synthesis, then the utterances
  over ``dp``.

The kernel runners (``make_sharded_enhance_mega``,
``make_sharded_tdgsc_fused``) split the batch over every mesh axis and
exchange nothing but the result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.array.steering import steering_vector
from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_init, enhance_scan
from distantspeech_tpu_torch.parallel._shard import (
    all_reduce_sum, batch_rows, bin_shard, device_of, gather_batch, take_bins,
)
from distantspeech_tpu_torch.transform import analysis, synthesis

DP = ("dp",)
ALL_AXES = ("dp", "fb")
_MXU = ("highest", "bf16x3")
_SUB = 8


def _dp_block(x, mesh) -> torch.Tensor:
    """The global batch on this rank's device, cut to its ``dp`` rows."""
    x = torch.as_tensor(x, device=device_of(mesh))
    return x[batch_rows(x.shape[0], mesh, DP)]


def _time_major(X: torch.Tensor) -> torch.Tensor:
    """[B, M, T, F] -> [T, B, F, M]."""
    return torch.movedim(torch.movedim(X, -3, -1), -3, 0)


def _look(look_angle_deg) -> np.ndarray:
    return np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi


def _on_bins(cfg: EnhanceConfig, width: int) -> EnhanceConfig:
    """``cfg`` with the STFT size whose ``half_bin`` is ``width``: MCRA's
    edge-bin masks then fall on the working range's first and last bins."""
    stft = dataclasses.replace(cfg.mvdr.stft, n_fft=2 * (width - 1))
    return dataclasses.replace(cfg, mvdr=dataclasses.replace(cfg.mvdr, stft=stft))


def enhance_process_sharded(
    x,
    steer,
    mesh,
    cfg: EnhanceConfig,
    n_mics: int,
) -> torch.Tensor:
    """MVDR+OM-LSA of a batch, utterances over ``dp`` and bins over ``fb``.

    x: [B, M, S] (the whole batch, on every rank); steer: [F, M].  Returns
    [B, S] on every rank.  The frame loop is ``beamform.enhance.enhance_scan``
    on the rank's bins and a one-bin halo each side, so it exchanges nothing
    a frame."""
    x = _dp_block(x, mesh)
    Zt = _time_major(analysis(x, cfg.stft))  # [T, b, F, M]
    sh = bin_shard(mesh, cfg.stft.half_bin, left=1, right=1)
    local = _on_bins(cfg, sh.width)
    Z = sh.work(Zt, 2)
    a = sh.work(torch.as_tensor(steer, device=Z.device), 0).to(Z.dtype)
    state = enhance_init(local, n_mics, batch_shape=Z.shape[1:-2], cdtype=Z.dtype, device=Z.device)
    _, Y = enhance_scan(local, a, state, Z)  # [T, b, width]
    Y = sh.gather(sh.own(Y, 2), mesh, 2)
    return gather_batch(synthesis(torch.movedim(Y, 0, -2), cfg.stft), mesh, DP)


def make_sharded_enhance(
    mesh,
    geometry: ArrayGeometry,
    look_angle_deg=(90.0, 0.0),
    cfg: EnhanceConfig = EnhanceConfig(),
):
    """The sharded flagship scan for a mesh.

    Returns f(x [B, M, S]) -> [B, S] with B divisible by the dp axis."""
    steer = np.asarray(steering_vector(geometry, _look(look_angle_deg), cfg.stft.n_fft), dtype=np.complex64)

    def run(x):
        return enhance_process_sharded(x, steer, mesh, cfg, geometry.n_mics)

    return run


def make_sharded_enhance_pallas(
    mesh,
    geometry: ArrayGeometry,
    look_angle_deg=(90.0, 0.0),
    cfg: EnhanceConfig = EnhanceConfig(),
    interpret: bool = False,
):
    """The flagship fast path over a ('dp','fb') mesh: the MCRA pre-scan
    (``noise.mcra.mcra_run``, the MCRA lane kernel on a card) on the rank's
    bins and their halo, then K1 (``ops.cuda_mvdr.fused_mvdr_scan``) on its
    (batch-shard x bin-shard) block.  Bins pad up to a multiple of the fb
    axis: padded bins carry gate=0, steer=1 and lam=1 and are dropped
    before synthesis.

    Returns f(x [B, M, S]) -> [B, S]; B divisible by dp.  ``interpret`` is
    the JAX package's Pallas interpret flag, unused: the mesh's device picks
    the kernels or their plain versions."""
    from distantspeech_tpu_torch.noise.mcra import mcra_run
    from distantspeech_tpu_torch.ops.cuda_mvdr import fused_mvdr_scan

    mv = cfg.mvdr
    steer = np.asarray(steering_vector(geometry, _look(look_angle_deg), cfg.stft.n_fft), dtype=np.complex64)

    def run(x):
        x = _dp_block(x, mesh)
        Zt = _time_major(analysis(x, cfg.stft))  # [T, b, F, M]
        sh = bin_shard(mesh, cfg.stft.half_bin, left=1, right=1)
        Zw = sh.work(Zt, 2)
        mc = dataclasses.replace(mv.mcra, nfft=2 * (sh.width - 1))  # edge bins on the working range
        lam, p, sr = mcra_run(mc, Zw[..., 0].abs() ** 2, return_sr=True)
        gate = p < mv.p_vad
        if mv.vad_guard:
            gate = gate & (sr <= mv.mcra.delta_s)
        a = sh.own(sh.work(torch.as_tensor(steer, device=Zt.device), 0), 0, 1.0)
        Y = fused_mvdr_scan(
            sh.own(Zw, 2), sh.own(gate.to(p.dtype), 2), a, alpha_v=mv.alpha_v, diag=mv.diag,
            rel_diag=mv.rel_diag, p=sh.own(p, 2), lam=sh.own(lam, 2, 1.0), alpha_xi=cfg.alpha_xi, gmin=cfg.gmin,
        )  # [T, b, size]
        Y = sh.gather(Y, mesh, 2)
        return gather_batch(synthesis(torch.movedim(Y, 0, -2), cfg.stft), mesh, DP)

    return run


def make_sharded_wpe(mesh, cfg=None):
    """Subband RLS-WPE dereverberation over a ('dp', 'fb') mesh.

    Every frame's RLS update is per bin, so the frame loop
    (``derev.wpe_run``, its ``constrain`` hook taking the rank's bins of the
    initial state) exchanges nothing; the bins are gathered before the
    synthesis.  Returns f(x [B, C, S]) -> [B, S] with B divisible by the dp
    axis."""
    from distantspeech_tpu_torch.derev.wpe import WpeConfig, wpe_run
    from distantspeech_tpu_torch.transform.subband import subband_analysis, subband_synthesis

    if cfg is None:
        cfg = WpeConfig()

    def run(x):
        x = _dp_block(x, mesh)
        D_tf = _time_major(subband_analysis(x, cfg.subband))  # [T, b, F, C]
        sh = bin_shard(mesh, cfg.half_bin)
        # the hook cuts the initial state to the working range; later states have its width already
        e = wpe_run(cfg, sh.work(D_tf, 2), constrain=lambda s: s if s.var.shape[1] == sh.width else take_bins(s, sh))
        e0 = sh.gather(sh.own(torch.movedim(e[..., 0], 0, -2), 2), mesh, 2)  # [b, T, F]
        return gather_batch(subband_synthesis(e0, cfg.subband), mesh, DP)

    return run


def _shard_spp(base, sh, mesh, frame: list):
    """``base`` (a McSpp config) on the working range of a bin shard: its
    ``nfft`` gives ``half_bin`` = the range (the McCDR's MCRA edge bins fall
    there), and its mid-band mean of q sums the rank's owned bins of the
    global band and all-reduces the partial sum and count over ``fb``."""
    if sh.n == 1:
        return base
    lo, hi = base.qband
    a = max(lo, sh.lo)
    b = max(min(hi, sh.hi), a)  # the owned part of the band: [a, b), maybe empty

    def qband_mean(self, q):
        part = q[..., a - sh.elo: b - sh.elo].sum(dim=-1)
        tot = all_reduce_sum(torch.stack([part, torch.full_like(part, b - a)], dim=-1), mesh, "fb", "frame",
                             frame[0])
        return tot[..., 0] / tot[..., 1]

    fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
    fields["nfft"] = 2 * (sh.width - 1)
    return type(f"Sharded{type(base).__name__}", (type(base),), {"qband_mean": qband_mean})(**fields)


def make_sharded_subband_gsc(
    mesh, geometry: ArrayGeometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0), cfg=None
):
    """The SubbandGSC over a ('dp', 'fb') mesh.

    The input-side transforms run on each rank's utterances; the McSpp
    covariances and the BM/AIC subband-LMS weights shard over bins (McSpp's
    MCRA with a one-bin halo).  Each block the rank all-reduces McSpp's
    mid-band q sum over ``fb``, and gathers the BM and AIC errors over
    ``fb`` before their synthesis, which needs every bin (the reference's
    SubbandAF time-domain dispatch).  Returns f(x [B, M, S]) -> [B, S]."""
    from distantspeech_tpu_torch.adaptive.feature import dc_notch, dc_notch_init
    from distantspeech_tpu_torch.array.alignment import time_alignment_filters
    from distantspeech_tpu_torch.beamform.subband_gsc import (
        SubbandGscConfig, core_step_on_bins, subband_gsc_core_init,
    )
    from distantspeech_tpu_torch.noise.mcspp import mcspp_init
    from distantspeech_tpu_torch.ops.fir import fir_filter_offline
    from distantspeech_tpu_torch.transform import stft_frames

    if cfg is None:
        cfg = SubbandGscConfig(n_mics=geometry.n_mics)
    L, scfg = cfg.frame_len, cfg.stft
    coeffs = np.asarray(time_alignment_filters(geometry, angle_rad), dtype=np.float32)  # as JAX's runner

    def run(x):
        x = _dp_block(x, mesh)
        T = x.shape[-1] // L
        _, xn = dc_notch(dc_notch_init(x.shape[:-1], dtype=x.dtype, device=x.device), x, radius=0.98)
        aligned = fir_filter_offline(xn, torch.as_tensor(coeffs, device=x.device).to(x.dtype))[..., : T * L]
        fbf = aligned.mean(dim=-2)
        fbf_d = torch.nn.functional.pad(fbf, (L, 0))[..., : T * L]
        pad = lambda a: torch.nn.functional.pad(a, (scfg.overlap, 0))
        sh = bin_shard(mesh, cfg.half_bin, left=1, right=1)
        D_all = sh.work(stft_frames(pad(aligned), scfg), 3)  # [b, M, T, width]
        Xf_all, Yf_all = (sh.work(stft_frames(pad(s), scfg), 2) for s in (fbf, fbf_d))  # [b, T, width]
        frame = [0]
        spp = _shard_spp(cfg.spp, sh, mesh, frame)
        Fn = sh.work(torch.as_tensor(cfg.spp.mccdr.fn_pair(), dtype=x.dtype, device=x.device), 0)
        state = subband_gsc_core_init(cfg, batch_shape=x.shape[:-2], dtype=x.dtype, device=x.device)
        state = state._replace(spp=mcspp_init(spp, x.shape[:-2], cdtype=D_all.dtype, device=x.device),
                               bm=take_bins(state.bm, sh, f_axis=2), aic=take_bins(state.aic, sh, f_axis=1))
        to_all = lambda e: sh.gather(sh.own(e, e.ndim - 1), mesh, e.ndim - 1, "frame", frame[0])
        to_bins = lambda U: sh.work(U, U.ndim - 1)
        outs = []
        for t in range(T):
            frame[0] = t
            state, (out, _, _) = core_step_on_bins(cfg, spp, Fn, state, D_all[..., t, :], Xf_all[..., t, :],
                                                   Yf_all[..., t, :], to_all, to_bins)
            outs.append(out)
        return gather_batch(torch.cat(outs, dim=-1), mesh, DP)

    return run


def make_sharded_gsc(mesh, geometry: ArrayGeometry, angle_rad=(197.0 / 180.0 * np.pi, 0.0), cfg=None):
    """The frequency-domain GSC over a ('dp','fb') mesh: the canceller and
    MC-MCRA states ([B, F, C, C] covariances, [B, F] statistics) shard over
    bins.  The MC-MCRA gain zeroes the first two bins of what it is given,
    so a rank works on its bins and the two below.  Returns
    f(x [B, M, S]) -> [B, S]."""
    from distantspeech_tpu_torch.beamform.gsc import GscConfig, gsc_init, gsc_step, gsc_steering

    if cfg is None:
        cfg = GscConfig(n_mics=geometry.n_mics)
    a_np = np.asarray(gsc_steering(cfg, geometry, angle_rad), dtype=np.complex64)

    def run(x):
        x = _dp_block(x, mesh)
        Zt = _time_major(analysis(x, cfg.stft))  # [T, b, F, M]
        sh = bin_shard(mesh, cfg.half_bin, left=2)
        Z = sh.work(Zt, 2)
        a = sh.work(torch.as_tensor(a_np, device=Z.device), 0).to(Z.dtype)
        state = take_bins(gsc_init(cfg, batch_shape=Z.shape[1:-2], cdtype=Z.dtype, device=Z.device), sh)
        Y = []
        for z in Z:
            state, y = gsc_step(cfg, a, state, z)
            Y.append(y)
        Y = sh.gather(sh.own(torch.stack(Y), 2), mesh, 2)  # [T, b, F]
        return gather_batch(synthesis(torch.movedim(Y, 0, -2), cfg.stft), mesh, DP)

    return run


def _check_sub(sub: int) -> None:
    if sub % _SUB:
        raise ValueError(f"sub must be a multiple of {_SUB}, got {sub}")


def _all_axes_block(x, mesh, sub: int, name: str) -> torch.Tensor:
    """The global batch on this rank's device, cut to its rows of a split
    over every mesh axis; each rank's rows a multiple of ``sub``, as JAX's
    kernels tile the batch."""
    x = torch.as_tensor(x, device=device_of(mesh))
    if x.ndim != 3:
        raise ValueError(f"{name} needs x of shape [B, M, S], got {tuple(x.shape)}")
    if x.shape[0] % (mesh.size() * sub):
        raise ValueError(f"{name} needs B divisible by n_devices * sub = {mesh.size()} * {sub}, got B={x.shape[0]}")
    return x[batch_rows(x.shape[0], mesh, ALL_AXES)]


def make_sharded_enhance_mega(
    mesh,
    geometry: ArrayGeometry,
    look_angle_deg=(90.0, 0.0),
    cfg: EnhanceConfig = EnhanceConfig(),
    interpret: bool = None,
    mxu: str = "highest",
    sub: int = 8,
    inv_mode: str = "ldl",
):
    """The mega kernel (K4, ``ops.cuda_enhance.fused_enhance_full``: the
    whole pipeline in one launch, with K3's Bennett updates under
    ``inv_mode='rank1'``) over the mesh, batch-data-parallel.

    Utterances are independent end to end, so the batch splits over every
    mesh axis and each rank runs the kernel on its rows: no collective but
    the gather of the result (``parallel.scaling.runner_collectives``).
    ``interpret``, ``mxu`` and ``sub`` are JAX's TPU knobs, inert here; a
    value JAX refuses is refused.

    Returns f(x [B, M, S]) -> [B, S]; B divisible by n_devices * sub."""
    from distantspeech_tpu_torch.ops.cuda_enhance import fused_enhance_full

    if mxu not in _MXU:
        raise ValueError(f"mxu must be 'highest' or 'bf16x3', got {mxu!r}")
    _check_sub(sub)
    steer = np.asarray(steering_vector(geometry, _look(look_angle_deg), cfg.stft.n_fft), dtype=np.complex64)

    def run(x):
        y = fused_enhance_full(_all_axes_block(x, mesh, sub, "make_sharded_enhance_mega"), steer, cfg,
                               inv_mode=inv_mode)
        return gather_batch(y, mesh, ALL_AXES)

    return run


def make_sharded_tdgsc_fused(
    mesh,
    geometry: ArrayGeometry,
    angle_rad=(197.0 / 180.0 * np.pi, 0.0),
    cfg=None,
    interpret: bool = None,
    sub: int = 8,
):
    """The fused TDGSC (K5, ``ops.cuda_flms.fused_tdgsc``) batch-data-parallel
    over every mesh axis; collective-free like the mega runner.  Returns
    f(x [B, M, S]) -> (out [B, S'], p [B, T, F], bm [B, M-1, S']); B
    divisible by n_devices * sub.  ``interpret`` and ``sub`` as in
    ``make_sharded_enhance_mega``."""
    from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig
    from distantspeech_tpu_torch.ops.cuda_flms import fused_tdgsc

    if cfg is None:
        cfg = TdGscConfig(n_mics=geometry.n_mics)
    _check_sub(sub)

    def run(x):
        outs = fused_tdgsc(_all_axes_block(x, mesh, sub, "make_sharded_tdgsc_fused"), geometry, angle_rad, cfg)
        return tuple(gather_batch(t, mesh, ALL_AXES) for t in outs)

    return run
