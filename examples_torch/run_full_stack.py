"""The full front-end stack (BASELINE config 5): AEC + dual-mic KWS tap +
time-domain GSC + OMLSA postfilter, offline and streaming.

Synthesizes a reverberant scene with a known far-end echo path, runs the
composed stack offline (the frame-loop backend; ``--fused`` runs the chain
of CUDA kernels K7 ``fused_aec`` -> K6 ``fused_kws`` -> K5 with the
postfilter, or their plain versions with ``--cpu``), then re-runs it chunk
by chunk through the streaming driver and reports the chunk-latency
contract.

    python examples_torch/run_full_stack.py [--cpu] [--fused]
"""

import sys

import numpy as np

from _common import demo_args, host, make_scene, maybe_save, si_sdr

args_extra_fused = "--fused" in sys.argv
if args_extra_fused:
    sys.argv.remove("--fused")
args = demo_args("full AEC+KWS+GSC+OMLSA stack, offline + streaming")

from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, full_stack_process  # noqa: E402
from distantspeech_tpu_torch.runtime.streaming import make_full_stack_stream, wav_chunks  # noqa: E402

fs = 16000
mix, geom, src = make_scene(n_mics=4, dur=4.0, snr=20.0, sir=10.0, seed=3)
S = mix.shape[-1] // 256 * 256
mix = mix[..., :S]

# far-end speech echoing into every mic through a decaying room path
rng = np.random.default_rng(9)
far = (rng.standard_normal(S) * 0.3).astype(np.float32)
h = (rng.standard_normal(64) * np.exp(-np.arange(64) / 12) * 0.5).astype(np.float32)
echo = np.convolve(far, h)[:S].astype(np.float32)
x = (mix + echo[None, :]).astype(np.float32)

cfg = FullStackConfig(n_mics=4)
backend = "fused" if args_extra_fused else "scan"
out, kws_clean, p = full_stack_process(
    x[None], far[None], geom, (90.0 / 180.0 * np.pi, 0.0), cfg, backend=backend, device=args.device,
)
out = host(out)[0]
print(f"offline ({backend}): out {out.shape}, kws tap {tuple(kws_clean.shape)}, p {tuple(p.shape)}")
if src is not None:
    # the stack is ~424 samples latent (non-causal AIC 128 + alignment
    # group delay + one postfilter hop 256): widen the lag search
    print(f"  echoey mic0 SI-SDR {si_sdr(x[0], src[:S], search_shift=700):6.2f} dB")
    print(f"  enhanced    SI-SDR {si_sdr(out, src[:S], search_shift=700):6.2f} dB")

# streaming: chunk rows 0..3 = mics, last row = far-end reference
proc = make_full_stack_stream(geom, (90.0, 0.0), cfg, chunk_size=1024, fs=fs, device=args.device)
stacked = np.concatenate([x, far[None, :]], axis=0)
y_stream = proc.run(wav_chunks(stacked, 1024))
rep = proc.latency_report()
print(f"streaming: {rep['chunks']} chunks, p50 {rep['p50_ms']} ms / "
      f"budget {rep['budget_ms']} ms, overflows {rep['overflows']}")
if not np.isfinite(y_stream).all():
    raise SystemExit("non-finite streaming output")

maybe_save(args, out, fs=fs)
