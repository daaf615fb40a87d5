"""Test configuration: run the suite on a virtual 8-device CPU mesh.

CPU tests are the first-principles ground truth (differential vs brute
force); accelerator correctness then follows from XLA portability,
mirroring the reference's strategy (ref /root/reference/test/gputests.jl:1-2).
The suite runs on the CPU unless ``JAX_PLATFORMS`` names another platform:
tests marked ``gpu`` need the card and skip elsewhere
(``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs them there).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from implicitbvh_tpu.utils import use_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
use_compile_cache()
