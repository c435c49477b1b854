"""Multi-process / multi-host launch glue.

Replacement for the reference's process-group bring-up
(``/root/reference/dgll/GPU Accelerator/MQGCN.py:100-109,161-163``:
``mp.spawn(run, nprocs=num_gpus)`` + ``init_process_group('nccl'|'gloo',
tcp://127.0.0.1:12345)``). Here every process calls
:func:`initialize_distributed` (JAX's coordination service plays the TCP
rendezvous role), after which ``jax.devices()`` spans ALL processes and the
single-controller mesh code in this package (``make_mesh`` + ``shard_map`` +
psum/all_to_all) works unchanged across hosts — routing the collectives is
XLA's (NCCL's) job.

``launch_local`` is the ``mp.spawn`` twin for one host: it forks N copies of a
script with the coordination env preset and gives child ``k`` the host's
``k``-th GPU alone (``CUDA_VISIBLE_DEVICES``): a JAX process reserves most of
every card it opens, so a child must not open its neighbours' cards. With
``JAX_PLATFORMS=cpu`` this is the cluster-free distributed test path (the
reference's "Gloo on one host" trick, SURVEY.md §4).
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import List, Optional, Sequence

ENV_COORD = "DGLL_COORDINATOR"
ENV_NPROC = "DGLL_NUM_PROCESSES"
ENV_PID = "DGLL_PROCESS_ID"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """``jax.distributed.initialize`` with env-var fallbacks (set by ``launch_local``
    or a cluster scheduler). No-op when num_processes == 1 and no env is set."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(ENV_COORD)
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NPROC, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PID, "0"))
    if num_processes <= 1 and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def is_primary() -> bool:
    """True on the process that should log/checkpoint (rank 0)."""
    import jax

    return jax.process_index() == 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card_for(pid: int, environ) -> str:
    """The one GPU child ``pid`` may see: the pid-th of the parent's visible
    cards (all of the host's when the parent sets none)."""
    visible = environ.get("CUDA_VISIBLE_DEVICES")
    if not visible:
        return str(pid)
    cards = visible.split(",")
    if pid >= len(cards):
        raise ValueError(f"process {pid} has no GPU: CUDA_VISIBLE_DEVICES={visible!r}")
    return cards[pid]


def launch_local(
    n_processes: int,
    argv: Sequence[str],
    env: Optional[dict] = None,
    timeout: float = 300.0,
) -> List[subprocess.CompletedProcess]:
    """Spawn ``n_processes`` copies of ``argv`` (e.g. ``[sys.executable, script]``)
    with the coordination env preset — the ``mp.spawn`` parity entry point.
    Child ``k`` sees one GPU, the ``k``-th visible one.

    Each child should call :func:`initialize_distributed` early. Returns the
    completed processes; raises if any exits non-zero (with its stderr).
    """
    import tempfile

    port = _free_port()
    procs = []
    files = []
    for pid in range(n_processes):
        child_env = dict(os.environ)
        if env:
            child_env.update(env)
        child_env[ENV_COORD] = f"127.0.0.1:{port}"
        child_env[ENV_NPROC] = str(n_processes)
        child_env[ENV_PID] = str(pid)
        child_env["CUDA_VISIBLE_DEVICES"] = _card_for(pid, os.environ)
        # child output goes to temp files, never pipes: the parent drains
        # children sequentially, and a child blocking on a full 64KB pipe while
        # another waits on a distributed collective deadlocks the whole launch
        fo = tempfile.TemporaryFile(mode="w+")
        fe = tempfile.TemporaryFile(mode="w+")
        files.append((fo, fe))
        procs.append(subprocess.Popen(list(argv), env=child_env, stdout=fo,
                                      stderr=fe, text=True))
    done = []
    failed = None
    try:
        for pid, p in enumerate(procs):
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            fo, fe = files[pid]
            fo.seek(0)
            fe.seek(0)
            out, err = fo.read(), fe.read()
            done.append(subprocess.CompletedProcess(argv, p.returncode, out, err))
            if p.returncode != 0 and failed is None:
                failed = (pid, err)
    finally:
        for fo, fe in files:
            fo.close()
            fe.close()
    if failed is not None:
        raise RuntimeError(
            f"process {failed[0]} exited non-zero; stderr:\n{failed[1][-4000:]}"
        )
    return done


if __name__ == "__main__":
    # Smoke entry: run under launch_local to verify the multi-process mesh.
    # Each process contributes its local CPU devices; a psum over the global
    # mesh must see every process's contribution.
    initialize_distributed()
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from jax import shard_map

    devices = jax.devices()
    mesh = Mesh(devices, ("data",))
    n = len(devices)

    @jax.jit
    def total(x):
        return shard_map(
            lambda v: jax.lax.psum(v, "data"),
            mesh=mesh, in_specs=P("data"), out_specs=P(),
        )(x)

    # global array [n] with value = global device index + 1
    local = jnp.asarray(
        [1.0 + d.id for d in jax.local_devices()], dtype=jnp.float32
    )
    gx = jax.make_array_from_single_device_arrays(
        (n,), NamedSharding(mesh, P("data")),
        [jax.device_put(local[i : i + 1], d)
         for i, d in enumerate(jax.local_devices())],
    )
    out = float(total(gx)[0])
    expect = sum(1.0 + d.id for d in devices)
    assert out == expect, (out, expect)
    if is_primary():
        print(f"MULTIPROC_OK procs={jax.process_count()} devices={n} psum={out}")
