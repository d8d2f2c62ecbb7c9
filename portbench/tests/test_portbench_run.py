"""run.py without a card, the import scan, and runs driven on the CPU with
the timed path broken underneath: each fault must make ``correct`` false,
and the sound run must not."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.harness import checks, runner, spec

BENCH = spec.BENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "distantspeech_tpu"}


def sources(folder: Path):
    return [p for p in folder.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports (relative imports excluded)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for p in sources(BENCH):
        tops = {n.split(".")[0] for n in imports(p)}  # the whole top-level name, not a prefix
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for p in sources(BENCH / "reference"):
        for name in imports(p):
            assert name.split(".")[0] != "distantspeech_tpu_torch", (p, name)
            if name.startswith("portbench."):
                assert name.startswith("portbench.reference."), (p, name)
    code = ("import sys; import portbench.reference.ami8_mvdr_omlsa, portbench.reference.respeaker4_full_stack; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, check=True)
    loaded = set(eval(out.stdout))
    assert not loaded & (FORBIDDEN | {"distantspeech_tpu_torch"}), loaded


def test_run_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ami8.mega.b256", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "CUDA device" in out.stderr and out.stdout == ""


def test_run_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ami8.mega.b256", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_modules_are_named_by_whole_top_level_names():
    import distantspeech_tpu_torch  # noqa: F401  (its name begins with the JAX package's)

    assert runner.forbidden_modules() == []


@pytest.mark.card
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ami8.mega.b16", "--seed", "7",
                          "--seconds", "2", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and list(line)[-1] == "checks"


def small(cell):
    c = spec.load_cell(cell)
    c.traffic.update(batch=4, utterance_s=2.5, pool=2)
    c.checks["calls"] = 2
    return c


def half_batch(entry):
    """The program run on the first half of the batch, the rest left out."""
    def call(batch):
        B = batch["x"].shape[0]
        out = entry({k: v[: B // 2] for k, v in batch.items()})
        return {k: torch.cat([v, torch.zeros_like(v)]) for k, v in out.items()}
    return call


def altered_answer(entry):
    """Utterance 0's answer replaced by utterance 1's where it is produced."""
    def call(batch):
        out = entry(batch)
        for v in out.values():
            v[0] = v[1]
        return out
    return call


def altered_blocks(entry):
    """The enhanced waveform doubled in one of each five blocks of 256
    samples, where it is produced; the other outputs left alone."""
    def call(batch):
        out = entry(batch)
        for k in {"y", "enhanced"} & set(out):
            v = out[k]
            every_fifth = torch.arange(v[0].numel()) // checks.BLOCK % 5 == 0
            v.mul_((1.0 + every_fifth.to(v.dtype)).reshape(v.shape[1:]).to(v.device))
        return out
    return call


@pytest.mark.parametrize("cell", ["ami8.mega.b16", "respeaker4.fused.b16"])
@pytest.mark.parametrize("fault", [None, half_batch, altered_answer, altered_blocks],
                         ids=["sound", "half_batch", "altered_answer", "altered_blocks"])
def test_faults_make_the_run_incorrect(cell, fault):
    result = runner.run(small(cell), 2**31 + 99, 0.5, False, device="cpu", call=fault)
    assert result["correct"] == (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
