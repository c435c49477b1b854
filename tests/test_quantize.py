"""Quantization/binarization: error bounds, gather-dequant, stochastic rounding."""
import numpy as np
import jax.numpy as jnp
import pytest

from dgll_tpu.ops.quantize import (
    QuantizedFeatures,
    binarize,
    quantization_error,
    quantize_int8,
)


@pytest.fixture
def x():
    rng = np.random.default_rng(0)
    return rng.normal(0, 2.0, size=(300, 64)).astype(np.float32)


def test_int8_roundtrip_error(x):
    qf = quantize_int8(x)
    assert qf.values.dtype == jnp.int8
    err = quantization_error(x, qf)
    assert err < 0.01, err  # <1% mean relative error


def test_gather_dequant_matches(x):
    qf = quantize_int8(x)
    ids = jnp.asarray([5, 0, 299, 100])
    out = np.asarray(qf.gather(ids))
    np.testing.assert_allclose(out, np.asarray(qf.dequantize())[[5, 0, 299, 100]],
                               rtol=1e-6)
    assert np.abs(out - x[[5, 0, 299, 100]]).mean() < 0.05


def test_binarize(x):
    signs, scale = binarize(x)
    assert set(np.unique(np.asarray(signs))) <= {-1, 1}
    recon = np.asarray(signs, np.float32) * np.asarray(scale)[None, :]
    # sign agreement ~100%, magnitude approximate
    agree = (np.sign(recon) == np.sign(x)).mean()
    assert agree > 0.99


def test_stochastic_quantizer_within_one_step(x):
    qf_x = quantize_int8(x)
    qf_s = quantize_int8(x, stochastic=True, seed=3)
    np.testing.assert_allclose(np.asarray(qf_s.scale), np.asarray(qf_x.scale), rtol=1e-6)
    # stochastic rounding: values within 1 step of deterministic rounding
    diff = np.abs(
        np.asarray(qf_s.values, np.int32) - np.asarray(qf_x.values, np.int32)
    )
    assert diff.max() <= 1
    assert diff.max() == 1  # the noise does move some values
    assert quantization_error(x, qf_s) < 0.02
