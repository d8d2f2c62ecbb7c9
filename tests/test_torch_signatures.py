"""The port's public signatures against the JAX package's: for every
public function of every ``distantspeech_tpu`` module that has a twin
module in the port, the twin exists and takes the same parameters in the
same order, apart from ``device`` and the extras (after JAX's parameters)
and renames named here; ``ops`` exports what JAX's does; and JAX's
``unroll`` sits in its place in the port's entry points, inert, refusing a
string (an old positional ``backend``)."""

import importlib
import importlib.util
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import distantspeech_tpu
import distantspeech_tpu_torch.ops

# port-only parameters, by (module, function)
EXTRAS = {("beamform.enhance", "enhance_process"): ("t_chunk",),
          ("doa.wpe_srp", "wpe_srp_process"): ("return_dereverb",)}
# functions that carry another name in the port
RENAMES = {("array.steering", "steering_vector_jax"): "steering_vector_torch"}
# parameters that carry another name in the port: collective_stats reads the
# runners' recorded collectives where JAX reads the compiled HLO text
PARAM_RENAMES = {("parallel.scaling", "collective_stats"): {"hlo_text": "log"}}
SLICE_F = ("adaptive.nlms", "beamform.dios_gsc", "coherence.weights", "coherence.enhance", "postfilter.mccowan",
           "transform.multirate", "transform.griffin_lim", "sim.room", "sim.ism")
SLICE_G1 = ("runtime.io", "runtime.checkpoint", "runtime.streaming", "runtime.viz", "runtime.cli")
SLICE_G2 = ("parallel.mesh", "parallel.sharded", "parallel.scaling")


def _twin_modules():
    out = []
    for info in pkgutil.walk_packages(distantspeech_tpu.__path__, "distantspeech_tpu."):
        rel = info.name.split(".", 1)[1]
        try:
            found = importlib.util.find_spec(f"distantspeech_tpu_torch.{rel}") is not None
        except ModuleNotFoundError:  # its package is not ported yet
            found = False
        if found:
            out.append(rel)
    return out


MODULES = _twin_modules()


def _public_functions(mod):
    """Public functions defined in ``mod`` (jitted ones unwrapped)."""
    for name, obj in vars(mod).items():
        fn = inspect.unwrap(obj) if callable(obj) else None
        if not name.startswith("_") and inspect.isfunction(fn) and fn.__module__ == mod.__name__:
            yield name, fn


def test_slice_f_modules_have_twins():
    assert set(SLICE_F) <= set(MODULES)


def test_slice_g1_modules_have_twins():
    assert set(SLICE_G1) <= set(MODULES)
    jrt, trt = (importlib.import_module(f"{pkg}.runtime") for pkg in ("distantspeech_tpu", "distantspeech_tpu_torch"))
    assert {n for n in dir(jrt) if not n.startswith("_") and n not in SUBMODULES} <= set(dir(trt))


SUBMODULES = {"checkpoint", "cli", "full_stack", "io", "profiling", "streaming", "viz"}


def test_slice_g2_modules_have_twins():
    """``parallel``'s modules and exports, and the dry-run twin of the
    repository's ``__graft_entry__`` (``entry`` and ``dryrun_multichip``,
    each with ``device`` added)."""
    import __graft_entry__ as jentry

    from distantspeech_tpu_torch import graft_entry as tentry

    assert set(SLICE_G2) <= set(MODULES)
    jpar, tpar = (importlib.import_module(f"{pkg}.parallel") for pkg in ("distantspeech_tpu", "distantspeech_tpu_torch"))
    public = lambda m: {n for n in dir(m) if not n.startswith("_") and n not in ("mesh", "sharded", "scaling")}
    assert public(jpar) == public(tpar)
    for name in ("entry", "dryrun_multichip"):
        want = list(inspect.signature(getattr(jentry, name)).parameters)
        assert list(inspect.signature(getattr(tentry, name)).parameters) == want + ["device"], name


def test_streaming_processor_methods_match():
    """``StreamingProcessor``'s methods take JAX's parameters (and its
    constructor ``device`` after them)."""
    from distantspeech_tpu.runtime.streaming import StreamingProcessor as J
    from distantspeech_tpu_torch.runtime.streaming import StreamingProcessor as T

    for name in ("__init__", "process_chunk", "latency_report", "run"):
        want = list(inspect.signature(getattr(J, name)).parameters)
        got = list(inspect.signature(getattr(T, name)).parameters)
        assert got == want + (["device"] if name == "__init__" else []), name


def test_cli_parser_is_jax_parser_plus_cpu():
    """The CLI's options and defaults are JAX's, with ``--cpu`` added and the
    ``full_stack`` choice that JAX's ``--stream`` branch handles but its
    parser lacks."""
    from distantspeech_tpu.runtime import cli as jcli
    from distantspeech_tpu_torch.runtime import cli as tcli

    jopts = {a.dest: (a.default, a.choices) for a in jcli.build_parser()._actions}
    topts = {a.dest: (a.default, a.choices) for a in tcli.build_parser()._actions}
    assert topts.pop("cpu") == (False, None)
    assert topts.pop("pipeline") == ("enhance", jopts.pop("pipeline")[1] + ["full_stack"])
    assert topts == jopts


@pytest.mark.parametrize("rel", MODULES)
def test_public_signatures_match(rel):
    jmod = importlib.import_module(f"distantspeech_tpu.{rel}")
    tmod = importlib.import_module(f"distantspeech_tpu_torch.{rel}")
    for name, fn in _public_functions(jmod):
        twin_name = RENAMES.get((rel, name), name)
        twin = getattr(tmod, twin_name, None)
        assert twin is not None, f"{rel}.{name} has no twin {twin_name}"
        renamed = PARAM_RENAMES.get((rel, name), {})
        want = [renamed.get(p, p) for p in inspect.signature(fn).parameters]
        got = [p for p in inspect.signature(twin).parameters if p != "device"]
        extras = EXTRAS.get((rel, name), ())
        assert got == want + list(extras), f"{rel}.{name}: JAX {want}, port {got} (extras allowed: {extras})"


def test_ops_exports():
    jops = importlib.import_module("distantspeech_tpu.ops")
    assert distantspeech_tpu_torch.ops.__all__ == jops.__all__
    for name in jops.__all__:
        assert callable(getattr(distantspeech_tpu_torch.ops, name))


def _unroll_calls():
    """Each entry point that takes JAX's ``unroll``, called with a string in
    its place (a ``backend`` passed by position in the old order)."""
    from distantspeech_tpu_torch.array.geometry import ArrayGeometry
    from distantspeech_tpu_torch.beamform import enhance, fdgsc, gsc, subband_gsc, tdgsc
    from distantspeech_tpu_torch.noise import mcra
    from distantspeech_tpu_torch.runtime import full_stack

    x, g, a = torch.zeros(1, 4, 512), ArrayGeometry.linear(4, 0.032), (1.57, 0.0)
    return {
        "enhance_scan": lambda: enhance.enhance_scan(enhance.EnhanceConfig(), None, None, None, "fused"),
        "gsc_process": lambda: gsc.gsc_process(x, g, a, gsc.GscConfig(), "fused"),
        "tdgsc_process": lambda: tdgsc.tdgsc_process(x, g, a, tdgsc.TdGscConfig(n_mics=4), "fused"),
        "fdgsc_process": lambda: fdgsc.fdgsc_process(x, g, a, fdgsc.FdGscConfig(n_mics=4), True, "fused"),
        "subband_gsc_process": lambda: subband_gsc.subband_gsc_process(x, g, a, subband_gsc.SubbandGscConfig(), "fused"),
        "full_stack_process": lambda: full_stack.full_stack_process(x, x[:, 0], g, a, full_stack.FullStackConfig(),
                                                                    "fused"),
        "mcra_run": lambda: mcra.mcra_run(mcra.McraConfig(), torch.ones(3, 129), "fused"),
    }


@pytest.mark.parametrize("name", sorted(_unroll_calls()))
def test_unroll_refuses_a_positional_backend(name):
    with pytest.raises(TypeError, match="pass backend= by keyword"):
        _unroll_calls()[name]()


def test_unroll_is_inert():
    from distantspeech_tpu_torch.noise import mcra

    Y = torch.as_tensor(np.random.default_rng(0).random((12, 2, 129)) + 0.1)
    for got, want in zip(mcra.mcra_run(mcra.McraConfig(), Y, 3, True), mcra.mcra_run(mcra.McraConfig(), Y, return_sr=True)):
        assert torch.equal(got, want)
