"""Multi-process distributed bring-up: the reference's Gloo-on-one-host trick
(SURVEY.md §4, MQGCN.py:100-109) as a real 2-process jax.distributed test."""
import os
import sys

import pytest

from dgll_tpu.parallel.launch import launch_local


@pytest.mark.slow
def test_two_process_cpu_mesh_psum():
    env = {
        # CPU-only in the children: each process gets 2 virtual CPU devices
        # -> a 2-proc x 2-dev global mesh.
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
    }
    results = launch_local(
        2, [sys.executable, "-m", "dgll_tpu.parallel.launch"], env=env, timeout=240
    )
    out = "".join(r.stdout for r in results)
    assert "MULTIPROC_OK procs=2 devices=4" in out, out


@pytest.mark.slow
def test_two_process_dp_train_step_parity():
    """A REAL data-parallel train step across 2 processes (not just a psum):
    three DP minibatch GraphSAGE steps over a 2-proc x 2-dev global mesh must
    produce the same loss as the identical 1-proc x 4-dev run (VERDICT r2 #8;
    ref: the per-process training loop of MQGCN.py:114-157)."""
    import re
    import subprocess

    child = os.path.join(os.path.dirname(__file__), "_mp_dp_train_child.py")

    # single-process 4-device reference
    env1 = dict(os.environ)
    env1.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
    })
    r1 = subprocess.run([sys.executable, child], env=env1, capture_output=True,
                        text=True, timeout=240)
    m1 = re.search(r"MPDP_LOSS=([0-9.]+) procs=1 devices=4", r1.stdout)
    assert m1, (r1.stdout, r1.stderr[-2000:])

    # 2-process x 2-device global mesh
    env2 = {
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
    }
    results = launch_local(2, [sys.executable, child], env=env2, timeout=240)
    out = "".join(r.stdout for r in results)
    m2 = re.search(r"MPDP_LOSS=([0-9.]+) procs=2 devices=4", out)
    assert m2, out
    assert abs(float(m1.group(1)) - float(m2.group(1))) < 1e-4, (m1.group(1), m2.group(1))


@pytest.mark.slow
def test_two_process_device_sampling_dp_epoch_parity():
    """The DEVICE-SAMPLING DP epoch (sampling inside the scanned shard_map
    program, make_device_dp_epoch_fn) across 2 real processes: the same global
    4-device mesh must produce the same epoch loss as 1 proc x 4 devices
    (VERDICT r3 #8; ref: the full per-process loop of MQGCN.py:114-157)."""
    import re
    import subprocess

    child = os.path.join(os.path.dirname(__file__), "_mp_dp_device_child.py")

    env1 = dict(os.environ)
    env1.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
    })
    r1 = subprocess.run([sys.executable, child], env=env1, capture_output=True,
                        text=True, timeout=240)
    m1 = re.search(r"MPDPDEV_LOSS=([0-9.]+) procs=1 devices=4", r1.stdout)
    assert m1, (r1.stdout, r1.stderr[-2000:])

    env2 = {
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
    }
    results = launch_local(2, [sys.executable, child], env=env2, timeout=240)
    out = "".join(r.stdout for r in results)
    m2 = re.search(r"MPDPDEV_LOSS=([0-9.]+) procs=2 devices=4", out)
    assert m2, out
    assert abs(float(m1.group(1)) - float(m2.group(1))) < 1e-4, (
        m1.group(1), m2.group(1))
