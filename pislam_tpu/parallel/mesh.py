"""Device mesh construction for pislam-tpu.

The reference has zero parallelism infrastructure (SURVEY.md section 2:
no threads, no MPI/NCCL; single-core NEON). This framework scales along two
axes (BASELINE.json north star):

* "data"  -- frames: each device extracts/matches its own camera frames.
* "model" -- the map: landmarks + observations of a BA window are sharded;
             Schur reductions run as psums (backend/ba.py).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MeshConfig


def make_mesh(cfg: MeshConfig = MeshConfig(), devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    dp, mp = cfg.data_parallel, cfg.model_parallel
    if dp * mp != len(devices):
        raise ValueError(
            f"mesh {dp}x{mp} needs {dp * mp} devices, got {len(devices)}")
    arr = np.asarray(devices).reshape(dp, mp)
    return Mesh(arr, (cfg.data_axis, cfg.model_axis))


def data_sharding(mesh: Mesh, *trailing_none: int):
    return NamedSharding(mesh, P("data", *([None] * trailing_none)))


def model_sharding(mesh: Mesh, *trailing_none: int):
    return NamedSharding(mesh, P("model", *([None] * trailing_none)))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
