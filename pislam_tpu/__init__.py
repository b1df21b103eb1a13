"""pislam-tpu: a monocular ORB-SLAM engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of 0xfaded/pislam
(ORB feature-extraction frontend), grown into a full SLAM pipeline: on-device
pyramid construction, FAST-9 + Harris + NMS + rotated-BRIEF extraction as
dense batched array programs, Hamming matching as an int8 matmul, RANSAC
visual odometry, pose-graph optimisation and windowed sparse bundle
adjustment with Schur-complement reduction, sharded over device meshes with
XLA collectives.

Importing the package sets JAX's default matmul precision to "highest":
the float32 products of the geometry and the backend (RANSAC, PnP, BA, pose
graph, triangulation) then run in full float32 on GPUs instead of TF32. The
frontend's int8 products are exact at any precision.
"""

import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")

from .config import (  # noqa: F401
    BAConfig,
    FrontendConfig,
    MapConfig,
    MatcherConfig,
    MeshConfig,
    PislamConfig,
    PyramidConfig,
    VOConfig,
)
from .frontend import Features, extract_single_level, make_extract_fn  # noqa: F401

__version__ = "0.1.0"
