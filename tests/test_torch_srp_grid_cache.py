"""``doa.srp.srp_process`` builds its steering grid once per (config,
geometry, device): a second call with equal arguments (a new but equal
geometry object too) builds and copies no grid, and returns the same numbers
as the first; another geometry gets a grid of its own."""

import numpy as np
import torch

from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.doa import srp


def test_grid_built_once_per_config_and_geometry(monkeypatch):
    built = []
    build = srp.srp_steering_grid

    def counting(cfg, geometry):
        built.append(geometry.n_mics)
        return build(cfg, geometry)

    monkeypatch.setattr(srp, "srp_steering_grid", counting)
    monkeypatch.setattr(srp, "_GRIDS", {})
    x = np.random.default_rng(0).standard_normal((2, 4, 2048)).astype(np.float32)
    first = srp.srp_process(x, ArrayGeometry.linear(4, 0.032), backend="fused", device="cpu")
    again = srp.srp_process(x, ArrayGeometry.linear(4, 0.032), backend="fused", device="cpu")
    assert built == [4]
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    srp.srp_process(x, ArrayGeometry.linear(4, 0.032), backend="scan", device="cpu")  # the unpacked grid
    srp.srp_process(x, ArrayGeometry.linear(4, 0.05), backend="fused", device="cpu")
    assert built == [4, 4, 4]
    cached = srp.device_grid(srp.SrpConfig(), ArrayGeometry.linear(4, 0.032), "cpu", packed=False)
    np.testing.assert_array_equal(cached.numpy(), build(srp.SrpConfig(), ArrayGeometry.linear(4, 0.032)))
