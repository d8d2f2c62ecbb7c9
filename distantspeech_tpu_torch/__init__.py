"""distantspeech_tpu_torch — the PyTorch/CUDA port of ``distantspeech_tpu``.

The JAX package stays the reference; this package mirrors its module layout
and public names (``EnhanceConfig``, ``enhance_step``, ``enhance_process``,
...) so every function has a counterpart one directory over.  Inside, the
code is plain functions on tensors with an explicit device and dtype.  The
Pallas TPU kernels of the ported path are hand-written CUDA C++ kernels for
Hopper (``csrc/``), each with a plain PyTorch version beside it.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.

Ported so far: the flagship 8-mic MVDR + OM-LSA path (STFT -> MCRA -> gated
MVDR -> OM-LSA -> ISTFT) with its ``scan``, ``pallas``, ``fused`` and
``mega`` backends, and the time-domain GSC (DC notch -> alignment -> FBF /
blocking matrix -> MCRA-gated FLMS canceller, optionally the OM-LSA-multi
postfilter) with its ``scan`` and ``fused`` backends; the frequency-domain
GSC, the full streaming stack (AEC -> KWS cleaner -> TDGSC), the subband GSC
with McSpp (``beamform.subband_gsc``) and SRP-PHAT DOA (``doa.srp``), each
with ``scan`` and ``fused``.
"""

from distantspeech_tpu_torch._device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
