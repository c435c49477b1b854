"""chip_smoke.py: it refuses a host without a GPU, and its phases run end to
end at tiny sizes on the CPU (the card runs them at full size)."""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_CLASS = 5


@pytest.fixture(scope="module")
def small_products():
    return chip_smoke.products_like(3000, 8, 16, N_CLASS)


@pytest.fixture(scope="module")
def small_fullgraph():
    return chip_smoke.fullgraph_graph(600, 6, 16, N_CLASS)


@pytest.mark.parametrize("args", [[], ["--chips", "4"]])
def test_refuses_cpu(args):
    """Run as its user would: no GPU means a non-zero exit and no result line."""
    out = subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_refuses_directory_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_minibatch_phase(small_products):
    out = chip_smoke.phase_minibatch(*small_products, N_CLASS, hidden=16,
                                     fanouts=(4, 3), batch=64, train_frac=0.5)
    assert out["window"]["ms_per_batch"] > 0 and out["per_slot"]["ms_per_batch"] > 0
    assert np.isfinite(out["per_slot"]["loss"])


def test_parity_phase(small_products):
    out = chip_smoke.phase_parity(*small_products, N_CLASS, hidden=16,
                                  fanouts=(4, 3), batch=32)
    assert out["max_rel_highest"] <= 1e-5


def test_fullgraph_phase(small_fullgraph):
    spmm = chip_smoke.check_spmm(small_fullgraph, 16, iters=2)
    assert spmm["max_row_rel_err"] <= 1e-5
    layers = chip_smoke.check_layers(small_fullgraph, 16)
    assert set(layers) == {"gcn", "gat"}
    steps = chip_smoke.train_steps(small_fullgraph, 16, N_CLASS, steps=3)
    assert steps["gcn"]["loss_last"] < steps["gcn"]["loss_first"]


def test_cli_phase():
    out = chip_smoke.phase_cli(400, epochs=1)
    assert set(out) == {"device_sampling", "full_gcn"}


def test_four_card_phases(small_products, small_fullgraph):
    devs = jax.devices()[:4]
    epoch = chip_smoke.phase_dp_epoch(*small_products, N_CLASS, devs, hidden=16,
                                      fanouts=(4, 3), batch=64, train_frac=0.5)
    assert np.isfinite(epoch["loss"])
    dp = chip_smoke.phase_dp_step(*small_products, N_CLASS, devs, hidden=16,
                                  fanouts=(4, 3), per_device=16)
    assert np.isclose(dp["loss_dp"], dp["loss_one_card"], rtol=1e-4)
    part = chip_smoke.phase_partitioned(small_fullgraph, 16, devs)
    assert np.isfinite(part["gp_loss"])
