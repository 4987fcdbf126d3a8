"""Multi-process tier (parallel/distributed.py): initialize() no-op
contract and the 2-level (across x within processes) mesh factorization.
Real multi-process runs need >1 process; here the simulated layout must
produce the same mesh topology (8 virtual CPU devices, see conftest)."""

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from fhe_study_tpu.parallel import distributed, pipeline
import pytest


def test_initialize_single_process_noop():
    # nothing configured -> must not try to bring up a coordinator
    assert distributed.initialize() is False


def test_hybrid_mesh_layout():
    mesh = distributed.hybrid_mesh(ici={"ep": 2}, simulate_hosts=2)
    assert mesh.axis_names == ("dp", "ep", "sp", "tp")
    assert mesh.shape == {"dp": 4, "ep": 2, "sp": 1, "tp": 1}
    # host factor is OUTERMOST in dp: consecutive dp rows hold distinct
    # simulated hosts' devices in order
    devs = np.array(jax.devices()).reshape(4, 2)
    assert (mesh.devices[:, :, 0, 0] == devs).all()


def test_hybrid_mesh_collective_rides_mesh():
    import jax.numpy as jnp
    mesh = distributed.hybrid_mesh(ici={"ep": 2, "tp": 2}, simulate_hosts=2)
    assert mesh.shape == {"dp": 2, "ep": 2, "sp": 1, "tp": 2}
    x = jnp.arange(8.0).reshape(2, 2, 2)
    sh = NamedSharding(mesh, P("dp", "ep", "tp"))
    xs = jax.device_put(x, sh)
    got = jax.jit(lambda v: v.sum())(xs)
    assert float(got) == float(x.sum())


@pytest.mark.slow
def test_dryrun_hybrid_rns_and_sp():
    # the multi-host code path at production ring size, decrypt-verified
    pipeline.dryrun_hybrid(8)


def test_two_process_distributed_ct_mul():
    """REAL multi-process execution: two OS
    processes, jax.distributed coordination service, an 8-device global
    runtime (4 virtual CPU devices per process), a dp-sharded RNS-BFV
    ct-mul decrypt-verified per-process, and a genuine cross-process
    all-reduce — see scripts/distributed_worker.py for the program."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.join(os.path.dirname(__file__), "..")
    worker = os.path.join(root, "scripts", "distributed_worker.py")
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
        })
        procs.append(subprocess.Popen(
            [sys.executable, worker], env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
    for pid, out in enumerate(outs):
        assert f"DIST2PROC OK p{pid}" in out, out[-3000:]
        # phase 2: the RNS limb axis SPANS the two processes (dcn_axis="ep")
        # and the ct-mul's base-extension all_gathers cross them for real
        assert f"DIST2PROC EP OK p{pid}" in out, out[-3000:]


def test_hybrid_mesh_ep_spans_hosts():
    """dcn_axis="ep": the host factor lands OUTERMOST IN EP — simulated
    2-host layout pairs devices of different hosts along ep."""
    mesh = distributed.hybrid_mesh(ici={"ep": 1}, dcn_axis="ep",
                                   simulate_hosts=2)
    assert mesh.shape == {"dp": 4, "ep": 2, "sp": 1, "tp": 1}
    devs = np.array(jax.devices())
    # simulated host of device i = i // 4 (8 devices, 2 hosts)
    host = np.vectorize(lambda d: d.id // 4)(mesh.devices)
    assert (host[:, 0, 0, 0] == 0).all() and (host[:, 1, 0, 0] == 1).all()
