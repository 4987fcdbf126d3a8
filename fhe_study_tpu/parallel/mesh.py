"""Device-mesh construction and sharding helpers.

FHE's parallelism axes map onto a device mesh as (SURVEY §2.6):
  * dp  — ciphertext batch (data parallel; no collectives)
  * ep  — RNS/CRT limb axis (limb-parallel; all_gather at reconstruction)
  * sp  — polynomial coefficient axis (sequence-parallel analog; the
          four-step NTT exchanges tiles all_to_all)
  * tp  — GLWE mask / gadget-level axis (tensor parallel; psum reductions)
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              ep: int = 1, sp: int = 1) -> Mesh:
    """Build a (dp, ep, sp) mesh over the first dp*ep*sp devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if dp is None:
        dp = n // (ep * sp)
    assert dp * ep * sp <= len(devices), \
        f"need {dp * ep * sp} devices, have {len(devices)}"
    grid = np.array(devices[: dp * ep * sp]).reshape(dp, ep, sp)
    return Mesh(grid, axis_names=("dp", "ep", "sp"))


def batch_sharding(mesh: Mesh):
    """Shard the leading (batch) axis over dp."""
    return NamedSharding(mesh, P("dp"))


def shard_batch(x, mesh: Mesh):
    return jax.device_put(x, batch_sharding(mesh))
