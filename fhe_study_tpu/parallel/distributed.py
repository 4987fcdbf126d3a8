"""Multi-process execution: jax.distributed init + 2-level meshes.

The reference has no distributed story at all (single-process Rust; SURVEY
§2.6 comm row).  The design scales in two tiers:

  * within a process — the devices one process drives (the cards of one
    host, joined all to all by NVLink): ep/sp/tp axes; collectives
    (all_gather / all_to_all / psum) stay inside the process.
  * across processes — the dp (ciphertext batch) axis ONLY.  FHE batches
    are embarrassingly parallel across processes — no per-op cross-process
    collective is ever required, so the slower link never sits on the hot
    path.  (Keys are replicated; each process holds its batch shard.)

Launch recipe (every process, before any computation runs):

    from fhe_study_tpu.parallel import distributed
    distributed.initialize()            # reads JAX_COORDINATOR_ADDRESS,
                                        # JAX_NUM_PROCESSES, JAX_PROCESS_ID
    mesh = distributed.hybrid_mesh(ici={"ep": 2, "sp": 1, "tp": 2})
    # -> Mesh (dp = processes x rest, ep=2, sp=1, tp=2)

Single-process simulation (CI / 8 virtual CPU devices): the same
`hybrid_mesh` call with `simulate_hosts=2` factors the local devices into an
outermost process dimension feeding dp, producing a mesh with the exact
(across, within) axis layout a real multi-process launch gets — the sharded
programs compile and execute identically.
"""

import os

import numpy as np
import jax
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Bring up the multi-process JAX runtime.

    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID when
    args are None.  Returns True if a multi-process runtime was initialized,
    False for the single-process no-op (no coordinator configured)."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False          # single-process run — nothing to initialize
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return True


def hybrid_mesh(ici: dict[str, int] | None = None,
                dcn_axis: str = "dp",
                simulate_hosts: int | None = None) -> Mesh:
    """Build a (dp, ep, sp, tp) mesh with dp spanning processes and the
    given `ici` axis sizes within each process.

    Real multi-process (jax.process_count() > 1): uses
    mesh_utils.create_hybrid_device_mesh so the dp axis spans processes
    and ep/sp/tp stay within each process — collectives on ep/sp/tp never
    cross processes.

    Single-process: factors jax.devices() into
    (simulate_hosts or 1) x local, with the process factor outermost
    feeding dp — the simulated layout used by tests and
    dryrun_multichip."""
    ici = dict(ici or {})
    for ax in ("ep", "sp", "tp"):
        ici.setdefault(ax, 1)
    ici_total = ici["ep"] * ici["sp"] * ici["tp"]
    assert dcn_axis in ("dp", "ep"), dcn_axis
    axis_names = ("dp", "ep", "sp", "tp")

    def _ep_spanning(devices, groups):
        """Device grid with the process factor OUTERMOST IN EP —
        dcn_axis="ep": the RNS limb axis spans processes, so limb
        all_gathers (base extension) genuinely cross them.  Off the
        default layout deliberately: used to exercise cross-process
        collectives beyond all-reduce (SURVEY §2.6 comm row)."""
        n = len(devices)
        dp = n // (groups * ici_total)
        arr = np.array(devices).reshape(groups, dp, ici["ep"], ici["sp"],
                                        ici["tp"])
        arr = np.moveaxis(arr, 0, 1)        # [dp, groups, ep_i, sp, tp]
        return arr.reshape(dp, groups * ici["ep"], ici["sp"], ici["tp"])

    if jax.process_count() > 1:
        per_host = jax.local_device_count()
        assert per_host % ici_total == 0, \
            f"process has {per_host} devices, ici axes need {ici_total}"
        devices = sorted(jax.devices(),
                         key=lambda d: (d.process_index, d.id))
        if dcn_axis == "ep":
            devs = _ep_spanning(devices, jax.process_count())
            return Mesh(devs, axis_names=axis_names)
        dp = jax.device_count() // ici_total
        try:
            from jax.experimental import mesh_utils
            devs = mesh_utils.create_hybrid_device_mesh(
                mesh_shape=(dp // jax.process_count(), ici["ep"], ici["sp"],
                            ici["tp"]),
                dcn_mesh_shape=(jax.process_count(), 1, 1, 1))
        except ValueError:
            # backends without a slice_index attribute (mesh_utils counts
            # 1 slice): group by owning process instead — same topology,
            # dp outermost spanning the processes
            devs = np.array(devices).reshape(dp, ici["ep"], ici["sp"],
                                             ici["tp"])
        return Mesh(devs, axis_names=axis_names)

    devices = jax.devices()
    hosts = simulate_hosts or 1
    n = len(devices)
    assert n % (hosts * ici_total) == 0, \
        f"{n} devices don't factor into {hosts} hosts x {ici} ici"
    if dcn_axis == "ep":
        return Mesh(_ep_spanning(devices, hosts), axis_names=axis_names)
    dp = n // ici_total           # process factor folds into dp
    devs = np.array(devices).reshape(dp, ici["ep"], ici["sp"], ici["tp"])
    return Mesh(devs, axis_names=axis_names)
