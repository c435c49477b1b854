"""Device-keyed pieces that need no card: the compile-cache location, the
peaks table and byte model, bench.py's refusal of a CPU host, and
launch_local's one-card-per-child pinning."""
import os
import subprocess
import sys

import jax
import pytest

from benchmarks.peaks import PEAKS, aggregation_bytes, bound_share, peaks_for
from dgll_tpu.parallel.launch import _card_for, launch_local
from dgll_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_to_fixed_path_in_checkout(monkeypatch,
                                                          restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # the same path on every call: no pid, time or temp name in it
    assert compile_cache.enable_compile_cache() == path


def test_compile_cache_env_var_wins_and_sets_nothing(monkeypatch, tmp_path,
                                                     restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_peaks_table_has_h100_and_rejects_unknown_kinds():
    h100 = peaks_for("NVIDIA H100 80GB HBM3")
    assert h100["hbm_bytes_per_s"] == 3.35e12 and h100["bf16_flops"] == 989e12
    assert h100["tf32_flops"] == 495e12 and h100["f32_flops"] == 67e12
    assert all("source" in p for p in PEAKS.values())
    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for("cpu")


def test_aggregation_bytes_and_bound_share():
    # E*F*b gathered + N*F*b written + 12 bytes of index/weight per edge
    assert aggregation_bytes(10, 4, 8, 4) == 10 * 8 * 4 + 4 * 8 * 4 + 120
    kind = "NVIDIA H100 80GB HBM3"
    assert bound_share(3.35e12, 2.0, kind) == pytest.approx(0.5)
    with pytest.raises(KeyError):
        bound_share(1.0, 1.0, "NVIDIA A100-SXM4-80GB")


def test_bench_refuses_cpu():
    out = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0 and "measures the GPU" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("visible,expect", [
    (None, ["0", "1", "2"]), ("4,5,6", ["4", "5", "6"]), ("", ["0", "1", "2"]),
])
def test_card_for_each_child(visible, expect):
    env = {} if visible is None else {"CUDA_VISIBLE_DEVICES": visible}
    assert [_card_for(k, env) for k in range(3)] == expect


def test_card_for_too_few_cards():
    with pytest.raises(ValueError, match="no GPU"):
        _card_for(2, {"CUDA_VISIBLE_DEVICES": "0,1"})


def test_launch_local_pins_one_card_per_child(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    code = ("import os; print(os.environ['DGLL_PROCESS_ID'], "
            "os.environ['CUDA_VISIBLE_DEVICES'])")
    done = launch_local(3, [sys.executable, "-c", code], timeout=60)
    seen = sorted(r.stdout.split() for r in done)
    assert seen == [["0", "0"], ["1", "1"], ["2", "2"]]
