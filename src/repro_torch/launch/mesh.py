"""Meshes of positions, and the H100's hardware constants.

``make_production_mesh`` builds the 16x16 (one pod) and 2x16x16 (two pods)
meshes of the JAX package's production layout on the ``meta`` device: the
shapes the sharding rules resolve against, with nothing to run on.
``make_mesh_for_devices`` builds the small meshes of tests and cells over
given devices, positions cycling through them (eight positions on ``cpu``,
two on ``cuda:0``).
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.sharding.rules import Mesh


def _mesh(shape, axes, devices: Sequence) -> Mesh:
    n = int(np.prod(shape))
    arr = np.empty(n, dtype=object)
    arr[:] = list(itertools.islice(itertools.cycle(devices), n))
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16 data, 16 model), or (2 pod, 16 data, 16 model), on ``meta``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, [torch.device("meta")])


def make_mesh_for_devices(n_data: int, n_model: int, pods: int = 1,
                          devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh, or (pod, data, model) with ``pods`` > 1, whose
    positions cycle through ``devices`` (default: every CUDA card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass devices=['cpu']")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if pods > 1:
        return _mesh((pods, n_data, n_model), ("pod", "data", "model"),
                     devices)
    return _mesh((n_data, n_model), ("data", "model"), devices)


# H100 SXM5 (the card the port measures on): dense bf16 tensor-core peak,
# HBM3 bandwidth, and NVLink 4 per direction (900 GB/s bidirectional)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card
HBM_BW = 3.35e12                # bytes/s per card
NVLINK_BW = 450e9               # bytes/s per card, one direction
