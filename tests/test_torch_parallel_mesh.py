"""The port's mesh, its collective record and the multi-card dry-run, in a
gloo world of 4 CPU processes: ``make_mesh`` keeps JAX's shape rules and
refuses a shape or device list that does not fill the world and a backend
that does not fit the device (a gloo group for cards), and raises without
a card when given no devices; ``runner_collectives`` reports no
collective for the batch-parallel kernel runners and the fb exchanges of
the bin-sharded ones; ``measure_scaling`` times each mesh shape of the
world; ``dryrun_multichip(4, device="cpu")`` runs every runner."""

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_world as world  # noqa: E402

BIN_SHARDED = ("enhance_scan", "enhance_pallas", "wpe", "subband_gsc", "gsc")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return world.run_world(4, ["mesh_errors", "collectives", "scaling"], tmp_path_factory.mktemp("parallel_mesh"))


def _json(ranks, case):
    said = [json.loads(str(r["json"])) for r in ranks[case]]
    return said[0], said


def test_make_mesh_shape_rules_and_refusals(ranks):
    said, _ = _json(ranks, "mesh_errors")
    assert said["shape"] == "ValueError: mesh 4x2 != 4 devices"
    assert said["devices"].startswith("ValueError: 5 devices for a world of 4")
    assert said["backend"] == "RuntimeError: the process group runs gloo, but cuda devices need nccl"
    assert said["default"] == [["dp", "fb"], [1, 4]]  # no arguments: every device on fb, as in JAX
    assert said["placements"] == ["Shard(dim=0)", "Replicate()"]
    assert said["mega_batch"] == ("ValueError: make_sharded_enhance_mega needs B divisible by n_devices * sub = "
                                  "4 * 8, got B=36")
    assert said["dp_batch"] == "ValueError: a batch of 3 utterances does not split over dp = 2 ranks"


def test_kernel_runners_refuse_what_jax_refuses():
    """``mxu`` and ``sub`` are inert, but a value JAX's kernels refuse is
    refused, before the mesh is used."""
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.parallel import make_sharded_enhance_mega, make_sharded_tdgsc_fused

    geom = ArrayGeometry.linear(4, 0.032)
    with pytest.raises(ValueError, match="mxu must be 'highest' or 'bf16x3'"):
        make_sharded_enhance_mega(None, geom, mxu="bf16")
    with pytest.raises(ValueError, match="sub must be a multiple of 8"):
        make_sharded_enhance_mega(None, geom, sub=4)
    with pytest.raises(ValueError, match="sub must be a multiple of 8"):
        make_sharded_tdgsc_fused(None, geom, sub=12)
    make_sharded_enhance_mega(None, geom, interpret=True, mxu="bf16x3", sub=16)


def test_make_mesh_needs_a_card_without_devices(monkeypatch):
    from distantspeech_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not torch.distributed.is_initialized()
    for call in (lambda: make_mesh(), lambda: make_mesh(1, 1), lambda: make_mesh(devices=["cuda"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("name", ("enhance_mega", "tdgsc_fused"))
def test_batch_runners_record_no_collective(ranks, name):
    said, every = _json(ranks, "collectives")
    assert all(s == said for s in every)
    assert said[name]["mesh"] == "2x2" and said[name]["collectives"] == {}
    # the result's own gathers, over fb then dp: every rank returns the whole batch
    assert said[name]["output"]["all-gather"]["count"] == {"enhance_mega": 2, "tdgsc_fused": 6}[name]


@pytest.mark.parametrize("name", BIN_SHARDED)
def test_bin_sharded_runners_exchange_over_fb(ranks, name):
    said, _ = _json(ranks, "collectives")
    stats = said[name]["collectives"]
    if name == "subband_gsc":  # each block: McSpp's q sum, then the BM and AIC errors before their synthesis
        assert stats["all-reduce"]["count_per_step"] == 1 and stats["all-gather"]["count_per_step"] == 2
        assert stats["all-gather"]["count"] == 0 and stats["all-gather"]["bytes_per_step"] > 0
    else:  # the bins once, before synthesis; nothing a frame
        assert stats == {"all-gather": {"count": 1, "bytes": stats["all-gather"]["bytes"], "count_per_step": 0,
                                        "bytes_per_step": 0}} and stats["all-gather"]["bytes"] > 0
    assert said[name]["output"]["all-gather"]["count"] == 1  # the utterances over dp


def test_measure_scaling_covers_the_world_shapes(ranks):
    said, _ = _json(ranks, "scaling")
    assert [e["mesh"] for e in said] == ["1x4", "4x1", "2x2"]
    assert all(e["audio_seconds_per_s"] > 0 and "efficiency" not in e for e in said)
    assert said[1]["collectives"] == {} and said[0]["collectives"]["all-gather"]["count"] == 1


def test_collective_stats_counts_per_call_and_per_frame():
    from distantspeech_tpu_torch.parallel.scaling import collective_stats

    log = [{"op": "all-gather", "bytes": 10, "where": "call", "axis": "fb", "step": None},
           {"op": "all-gather", "bytes": 40, "where": "output", "axis": "dp", "step": None}]
    log += [{"op": op, "bytes": 8, "where": "frame", "axis": "fb", "step": t}
            for t in range(5) for op in ("all-reduce", "all-gather", "all-gather")]
    assert collective_stats(log) == {
        "all-gather": {"count": 1, "bytes": 10, "count_per_step": 2, "bytes_per_step": 16},
        "all-reduce": {"count": 0, "bytes": 0, "count_per_step": 1, "bytes_per_step": 8},
    }


def test_dryrun_multichip_on_cpu_ranks():
    from distantspeech_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(4, device="cpu")
