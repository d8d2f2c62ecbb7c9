"""The port's audio I/O and plots on the CPU: ``save_audio``,
``load_audio``, ``load_pcm`` and ``load_wav_dir`` give the JAX package's
arrays bit for bit (its int16 scales included: 1/32767 for one wav, 1/32768
for a directory), and ``viz`` writes its files from tensors and arrays."""

import os

import numpy as np
import pytest
import torch

from distantspeech_tpu.runtime import io as jio
from distantspeech_tpu_torch.runtime import io as tio
from distantspeech_tpu_torch.runtime import viz


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests add no parallel work of their own to
    a run that spreads files over workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("shape", [(1000,), (1000, 3)])
def test_save_and_load_audio_match_jax(shape, tmp_path):
    x = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    tio.save_audio(str(tmp_path / "t"), x)  # the .wav suffix is added
    jio.save_audio(str(tmp_path / "j.wav"), x)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    _equal(tio.load_audio(str(tmp_path / "t.wav")), jio.load_audio(str(tmp_path / "t.wav")))


def test_load_pcm_and_wav_dir_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    for c, n in enumerate((760, 800, 900)):  # ragged: truncated to the first (pcm) or the shortest (wav)
        (rng.integers(-32768, 32767, n).astype("<i2")).tofile(tmp_path / f"ch{c}.pcm")
        tio.save_audio(str(tmp_path / f"ch{c}.wav"), rng.uniform(-1, 1, n).astype(np.float32), fs=8000)
    (tmp_path / "notes.txt").write_text("ignored")
    assert tio.find_files(str(tmp_path), ".pcm") == jio.find_files(str(tmp_path), ".pcm")
    _equal(tio.pcmread(str(tmp_path / "ch0.pcm")), jio.pcmread(str(tmp_path / "ch0.pcm")))
    _equal(tio.load_pcm(str(tmp_path)), jio.load_pcm(str(tmp_path)))
    got, sr = tio.load_wav_dir(str(tmp_path))
    want, jsr = jio.load_wav_dir(str(tmp_path))
    _equal(got, want)
    assert sr == jsr == 8000 and got.shape == (3, 760)


def test_viz_writes_its_files(tmp_path):
    rng = np.random.default_rng(2)
    spec = torch.as_tensor(rng.random((33, 20)))
    x, y = rng.standard_normal(4000), torch.as_tensor(rng.standard_normal(4000))
    for fn, args, name in ((viz.mesh, (spec,), "mesh.png"), (viz.pmesh, (spec.numpy(),), "pmesh.png"),
                           (viz.visual, (x, y), "visual.png"), (viz.visual, (x,), "visual_in.png")):
        fig = fn(*args, save=str(tmp_path / name))
        assert fig is not None and os.path.getsize(tmp_path / name) > 1000
