"""Realtime-style streaming driver: a host chunk source feeding an eager step.

Counterpart of ``distantspeech_tpu/runtime/streaming.py``.  A capture
source delivers fixed-size chunks; each chunk runs through one streaming
step that carries the pipeline state on the processor's device; a latency
monitor flags an overflow when a chunk takes longer than its real-time
budget.  The step runs eagerly (there is no compile), so the first chunk
carries only one-time costs: a kernel build if any, cuBLAS handles and the
DFT matrices moved to the device.  The audio-device layer is pluggable: any
iterator of [C, chunk] arrays works; a PyAudio source is provided when that
package is installed.

Each factory's step loops the pipeline's ``*_step`` over the chunk's frames
in Python, where the JAX package runs ``lax.scan``.  The state stays on the
device between chunks; only its host ints (MCRA's frame counters, the
AEC's ``cnt``) live on the host.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device


class StreamingProcessor:
    """Drive a ``step(state, chunk) -> (state, out)`` function chunk by chunk.

    Parameters
    ----------
    step : callable
        Streaming step on tensors of ``device``.
    init_state : nest of tensors
        Initial carry (from the pipeline's ``*_init``), on ``device``.
    chunk_size : int
        Samples per chunk per channel (the reference uses 1024).
    fs : int
        Sample rate, for the real-time overflow check.
    device : the device the chunks go to; ``None`` means the CUDA card.
    """

    def __init__(self, step: Callable, init_state: Any, chunk_size: int = 1024, fs: int = 16000, device=None):
        self.step = step
        self.state = init_state
        self.chunk_size = chunk_size
        self.fs = fs
        self.device = resolve_device(device)
        self.overflows = 0
        self.chunks = 0
        self.latencies: list = []  # seconds per chunk, incl. host<->device

    def process_chunk(self, chunk: np.ndarray) -> np.ndarray:
        """One chunk, timed from the host array to the host array: the copy
        to the device, the step, and the output's copy back, which waits for
        the device."""
        budget = self.chunk_size / self.fs
        t0 = time.perf_counter()
        x = torch.as_tensor(chunk, device=self.device)
        self.state, out = self.step(self.state, x)
        out = out.cpu().numpy()
        dt = time.perf_counter() - t0
        self.latencies.append(dt)
        if dt > budget:
            self.overflows += 1  # the reference's "time_cost overflow"
        self.chunks += 1
        return out

    def latency_report(self, skip_warmup: int = 1) -> dict:
        """Machine-readable chunk-latency summary.

        ``skip_warmup`` chunks (the one-time costs of the first chunk) are
        excluded from the percentile stats AND from ``overflows``: a warmup
        is not a latency miss, and a consumer gating on ``overflows == 0``
        should see the steady-state realtime contract.  The raw count
        including warmup is reported as ``overflows_incl_warmup``; the
        exclusion is capped so at least one chunk remains, and the report
        records it as ``warmup_excluded``.
        """
        skipped = min(skip_warmup, max(len(self.latencies) - 1, 0))
        lat = np.asarray(self.latencies[skipped:])
        budget = self.chunk_size / self.fs
        ms = lambda v: round(float(v) * 1e3, 4)
        return {
            "chunks": self.chunks,
            "overflows": int(np.sum(lat > budget)),
            "overflows_incl_warmup": self.overflows,
            "chunk_size": self.chunk_size,
            "fs": self.fs,
            "budget_ms": ms(budget),
            "warmup_excluded": skipped,
            "p50_ms": ms(np.percentile(lat, 50)) if lat.size else None,
            "p95_ms": ms(np.percentile(lat, 95)) if lat.size else None,
            "max_ms": ms(lat.max()) if lat.size else None,
            "mean_ms": ms(lat.mean()) if lat.size else None,
            "realtime_factor": round(budget / float(lat.mean()), 2) if lat.size else None,
        }

    def run(self, source: Iterable[np.ndarray], sink: Optional[Callable[[np.ndarray], None]] = None):
        """Consume a chunk iterator; returns concatenated output if no sink."""
        outs = []
        for chunk in source:
            out = self.process_chunk(chunk)
            if sink is not None:
                sink(out)
            else:
                outs.append(out)
        if outs:
            return np.concatenate(outs, axis=-1)
        return None


def _check_chunk(chunk_size: int, unit: int, what: str) -> None:
    if chunk_size % unit != 0:
        raise ValueError(f"chunk_size {chunk_size} must be a multiple of {what} {unit}")


def _alignment(geometry, look_angle_deg, chunk_size: int, dev):
    """The look direction's alignment FIR as the [M, K-1+chunk, chunk] block
    matrix of ``fir_filter_block`` for one chunk, and its zero tail carry."""
    from distantspeech_tpu_torch.array.alignment import time_alignment_filters
    from distantspeech_tpu_torch.ops.fir import fir_block_taps

    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    coeffs = torch.as_tensor(np.asarray(time_alignment_filters(geometry, angle_rad), dtype=np.float32), device=dev)
    cache = torch.zeros((coeffs.shape[0], coeffs.shape[-1] - 1), dtype=torch.float32, device=dev)
    return fir_block_taps(coeffs, chunk_size), cache


def make_enhance_stream(
    geometry, look_angle_deg=(90.0, 0.0), cfg=None, chunk_size: int = 1024, fs: int = 16000, device=None,
) -> "StreamingProcessor":
    """Streaming flagship pipeline (MVDR + OM-LSA) as a StreamingProcessor:
    chunk [M, chunk_size] in, [chunk_size] enhanced samples out (cfg.stft.hop
    must divide chunk_size).  The carry is the STFT tails, the covariances
    and the MCRA minima."""
    from distantspeech_tpu_torch.array.steering import steering_vector
    from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, enhance_init, enhance_scan
    from distantspeech_tpu_torch.transform.stft import istft_stream, stft_stream

    dev = resolve_device(device)
    if cfg is None:
        cfg = EnhanceConfig()
    _check_chunk(chunk_size, cfg.stft.hop, "hop")
    M = geometry.n_mics
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    steer = torch.as_tensor(np.asarray(steering_vector(geometry, angle_rad, cfg.stft.n_fft), dtype=np.complex64),
                            device=dev)

    def step(state, x_chunk):
        cin, cout, enh = state
        cin, Z = stft_stream(cin, x_chunk, cfg.stft)  # [M, J, F]
        Zt = torch.movedim(Z, -2, 0).transpose(-1, -2)  # [J, F, M]
        enh, Y = enhance_scan(cfg, steer, enh, Zt)
        cout, y = istft_stream(cout, Y, cfg.stft)
        return (cin, cout, enh), y

    init = (
        torch.zeros((M, cfg.stft.overlap), dtype=torch.float32, device=dev),
        torch.zeros(cfg.stft.overlap, dtype=torch.float32, device=dev),
        enhance_init(cfg, M, device=dev),
    )
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs, device=dev)


def make_gsc_stream(
    geometry, look_angle_deg=(90.0, 0.0), cfg=None, chunk_size: int = 1024, fs: int = 16000, device=None,
) -> "StreamingProcessor":
    """Streaming frequency-domain GSC.  Defaults to the production-robust
    configuration (normalised AIC + relative SPP diagonal loading); pass an
    explicit ``GscConfig`` for the reference-exact one.  Chunk
    [M, chunk_size] in, [chunk_size] out."""
    from distantspeech_tpu_torch.beamform.gsc import GscConfig, gsc_init, gsc_step, gsc_steering
    from distantspeech_tpu_torch.transform.stft import istft_stream, stft_stream

    dev = resolve_device(device)
    if cfg is None:
        cfg = GscConfig(n_mics=geometry.n_mics, normalize_aic=True, spp_rel_diag=1e-5)
    _check_chunk(chunk_size, cfg.stft.hop, "hop")
    M = cfg.n_mics
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    a = torch.as_tensor(np.asarray(gsc_steering(cfg, geometry, angle_rad), dtype=np.complex64), device=dev)

    def step(state, x_chunk):
        cin, cout, gs = state
        cin, Z = stft_stream(cin, x_chunk, cfg.stft)  # [M, J, F]
        Zt = torch.movedim(Z, -2, 0).transpose(-1, -2)  # [J, F, M]
        az = a.to(Zt.dtype)
        Y = []
        for z in Zt:
            gs, y = gsc_step(cfg, az, gs, z)
            Y.append(y)
        cout, y = istft_stream(cout, torch.stack(Y), cfg.stft)
        return (cin, cout, gs), y

    init = (
        torch.zeros((M, cfg.stft.overlap), dtype=torch.float32, device=dev),
        torch.zeros(cfg.stft.overlap, dtype=torch.float32, device=dev),
        gsc_init(cfg, device=dev),
    )
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs, device=dev)


def make_fdgsc_stream(
    geometry, look_angle_deg=(90.0, 0.0), cfg=None, chunk_size: int = 1024, fs: int = 16000,
    dc_notch_input: bool = True, device=None,
) -> "StreamingProcessor":
    """Streaming overlap-save robust GSC.  The offline driver's
    whole-signal preprocessing (DC notch IIR + time alignment FIR) becomes
    two more carries; the block step is the same ``fdgsc_step``."""
    from distantspeech_tpu_torch.adaptive.feature import dc_notch, dc_notch_init
    from distantspeech_tpu_torch.beamform.fdgsc import FdGscConfig, fdgsc_init, fdgsc_step
    from distantspeech_tpu_torch.ops.fir import fir_filter_block

    dev = resolve_device(device)
    if cfg is None:
        cfg = FdGscConfig(n_mics=geometry.n_mics)
    L = cfg.frame_len
    _check_chunk(chunk_size, L, "frame_len")
    M = cfg.n_mics
    taps, cache = _alignment(geometry, look_angle_deg, chunk_size, dev)
    J = chunk_size // L

    def step(state, x_chunk):
        dc, cache, ps = state
        xn = x_chunk
        if dc_notch_input:
            dc, xn = dc_notch(dc, x_chunk, radius=0.98)
        cache, aligned = fir_filter_block(cache, xn, taps)
        xb = torch.movedim(xn.reshape(M, J, L), 1, 0)  # [J, M, L]
        ab = torch.movedim(aligned.reshape(M, J, L), 1, 0)
        outs = []
        for j in range(J):
            ps, (out, _, _) = fdgsc_step(cfg, ps, xb[j], ab[j])
            outs.append(out)
        return (dc, cache, ps), torch.cat(outs)

    init = (dc_notch_init((M,), device=dev), cache, fdgsc_init(cfg, device=dev))
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs, device=dev)


def make_subband_gsc_stream(
    geometry, look_angle_deg=(90.0, 0.0), cfg=None, chunk_size: int = 1024, fs: int = 16000, device=None,
) -> "StreamingProcessor":
    """Streaming SubbandGSC: DC notch + time alignment carries feeding
    ``subband_gsc_step``."""
    from distantspeech_tpu_torch.adaptive.feature import dc_notch, dc_notch_init
    from distantspeech_tpu_torch.beamform.subband_gsc import SubbandGscConfig, subband_gsc_init, subband_gsc_step
    from distantspeech_tpu_torch.ops.fir import fir_filter_block

    dev = resolve_device(device)
    if cfg is None:
        cfg = SubbandGscConfig(n_mics=geometry.n_mics)
    L = cfg.frame_len
    _check_chunk(chunk_size, L, "frame_len")
    M = cfg.n_mics
    taps, cache = _alignment(geometry, look_angle_deg, chunk_size, dev)
    Fn = torch.as_tensor(np.asarray(cfg.spp.mccdr.fn_pair(), dtype=np.float32), device=dev)
    J = chunk_size // L

    def step(state, x_chunk):
        dc, cache, ps = state
        dc, xn = dc_notch(dc, x_chunk, radius=0.98)
        cache, aligned = fir_filter_block(cache, xn, taps)
        ab = torch.movedim(aligned.reshape(M, J, L), 1, 0)  # [J, M, L]
        outs = []
        for blk in ab:
            ps, (out, _, _) = subband_gsc_step(cfg, Fn, ps, blk)
            outs.append(out)
        return (dc, cache, ps), torch.cat(outs)

    init = (dc_notch_init((M,), device=dev), cache, subband_gsc_init(cfg, device=dev))
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs, device=dev)


def make_wpe_stream(
    geometry=None, look_angle_deg=None, cfg=None, chunk_size: int = 1024, fs: int = 16000,
    n_channels: int = None, device=None,
) -> "StreamingProcessor":
    """Streaming adaptive WPE dereverberation: the subband analysis carry, a
    ``delay``-frame regressor delay line, the RLS state and the synthesis
    time-delay line.  Geometry and angle are accepted (and ignored) for
    registry uniformity.  Chunk [C, chunk_size] in, [chunk_size]
    dereverberated reference channel out."""
    from distantspeech_tpu_torch.derev.wpe import WpeConfig, wpe_init, wpe_step
    from distantspeech_tpu_torch.transform.subband import (
        subband_analysis_stream, subband_synthesis_init, subband_synthesis_step,
    )

    dev = resolve_device(device)
    if cfg is None:
        C = n_channels or (geometry.n_mics if geometry is not None else 2)
        cfg = WpeConfig(n_channels=C)
    C = cfg.n_channels
    sb = cfg.subband
    _check_chunk(chunk_size, sb.hop, "hop")
    h, g = (torch.as_tensor(np.asarray(p, dtype=np.float32), device=dev) for p in sb.prototypes())
    J = chunk_size // sb.hop

    def step(state, x_chunk):
        cin, dbuf, ws, tdl = state
        cin, Y = subband_analysis_stream(cin, x_chunk, sb, h)  # [C, J, F]
        Dt = torch.movedim(Y, 0, -1)  # [J, F, C]
        ext = torch.cat([dbuf, Dt], dim=0)  # [delay + J, F, C]
        delayed, dbuf = ext[:J], ext[J:]
        ys = []
        for d, xd in zip(Dt, delayed):
            ws, e = wpe_step(cfg, ws, d, xd)
            tdl, y = subband_synthesis_step(tdl, e[..., 0], sb, g)
            ys.append(y)
        return (cin, dbuf, ws, tdl), torch.cat(ys)

    init = (
        torch.zeros((C, sb.overlap), dtype=torch.float32, device=dev),
        torch.zeros((cfg.delay, sb.half_bin, C), dtype=torch.complex64, device=dev),
        wpe_init(cfg, device=dev),
        subband_synthesis_init((), sb, device=dev),
    )
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs, device=dev)


def make_tdgsc_stream(
    geometry, look_angle_deg=(197.0, 0.0), cfg=None, chunk_size: int = 1024, fs: int = 16000, device=None,
) -> "StreamingProcessor":
    """Streaming time-domain GSC: DC notch + alignment FIR carries feeding
    ``tdgsc_step``.  Chunk [M, chunk_size] in, [chunk_size] out."""
    from distantspeech_tpu_torch.adaptive.feature import dc_notch, dc_notch_init
    from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig, tdgsc_init, tdgsc_step
    from distantspeech_tpu_torch.ops.fir import fir_filter_block

    dev = resolve_device(device)
    if cfg is None:
        cfg = TdGscConfig(n_mics=geometry.n_mics)
    L = cfg.frame_len
    _check_chunk(chunk_size, L, "frame_len")
    M = cfg.n_mics
    taps, cache = _alignment(geometry, look_angle_deg, chunk_size, dev)
    J = chunk_size // L

    def step(state, x_chunk):
        dc, cache, ts = state
        dc, xn = dc_notch(dc, x_chunk, radius=0.98)
        cache, aligned = fir_filter_block(cache, xn, taps)
        fb = aligned.mean(dim=-2).reshape(J, L)
        bb = torch.movedim((aligned[:-1] - aligned[1:]).reshape(M - 1, J, L), 1, 0)  # [J, M-1, L]
        outs = []
        for j in range(J):
            ts, (out, _) = tdgsc_step(cfg, ts, fb[j], bb[j])
            outs.append(out)
        return (dc, cache, ts), torch.cat(outs)

    init = (dc_notch_init((M,), device=dev), cache, tdgsc_init(cfg, device=dev))
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs, device=dev)


def make_full_stack_stream(
    geometry, look_angle_deg=(197.0, 0.0), cfg=None, chunk_size: int = 1024, fs: int = 16000, device=None,
) -> "StreamingProcessor":
    """Streaming FULL stack (BASELINE config 5): AEC (MDF two-path) per mic
    + dual-mic KWS tap + TDGSC + OM-LSA postfilter, one carry, one chunk
    step.

    Chunk layout [M + 1, chunk_size]: rows 0..M-1 are the microphones, the
    LAST row is the far-end playback reference (the echo path input the
    offline driver takes as a separate argument).  Output [chunk_size] is
    the enhanced signal."""
    from distantspeech_tpu_torch.array.alignment import time_alignment_filters
    from distantspeech_tpu_torch.ops.fir import fir_block_taps
    from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, full_stack_init, full_stack_step

    dev = resolve_device(device)
    if cfg is None:
        cfg = FullStackConfig(n_mics=geometry.n_mics)
    L = cfg.frame_len
    _check_chunk(chunk_size, L, "frame_len")
    M = cfg.n_mics
    angle_rad = np.asarray(look_angle_deg, dtype=np.float64) / 180.0 * np.pi
    coeffs_np = np.asarray(time_alignment_filters(geometry, angle_rad), dtype=np.float32)
    J = chunk_size // L
    # the Toeplitz taps, built once outside the per-chunk frame loop
    taps = fir_block_taps(torch.as_tensor(coeffs_np, device=dev), L)

    def step(state, chunk):
        xb = torch.movedim(chunk[:-1].reshape(M, J, L), 1, 0)  # [J, M, L]
        fb = chunk[-1].reshape(J, L)
        outs = []
        for j in range(J):
            state, (out, _, _) = full_stack_step(cfg, taps, state, xb[j], fb[j])
            outs.append(out)
        return state, torch.cat(outs)

    init = full_stack_init(cfg, coeffs_np, device=dev)
    return StreamingProcessor(step, init, chunk_size=chunk_size, fs=fs, device=dev)


#: pipeline-name -> stream factory; the CLI's --stream resolves here (the
#: reference's realtime loop drives any enhancement method; this registry
#: is that contract).
STREAM_FACTORIES = {
    "enhance": make_enhance_stream,
    "gsc": make_gsc_stream,
    "fdgsc": make_fdgsc_stream,
    "subband_gsc": make_subband_gsc_stream,
    "wpe": make_wpe_stream,
    "tdgsc": make_tdgsc_stream,
    "full_stack": make_full_stack_stream,
}


def wav_chunks(x: np.ndarray, chunk_size: int) -> Iterator[np.ndarray]:
    """Slice [C, S] audio into [C, chunk_size] chunks (tail dropped)."""
    for i in range(0, x.shape[-1] - chunk_size + 1, chunk_size):
        yield x[..., i : i + chunk_size]


def pyaudio_chunks(chunk_size: int = 1024, fs: int = 16000, channels: int = 6, pick=slice(1, 5)):
    """Live capture source (requires the optional ``pyaudio`` package)."""
    import pyaudio  # noqa: optional dependency

    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=channels, rate=fs, input=True,
                     frames_per_buffer=chunk_size)
    try:
        while True:
            raw = stream.read(chunk_size)
            data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
            yield data.reshape(chunk_size, channels).T[pick]
    finally:
        stream.stop_stream()
        stream.close()
        pa.terminate()
