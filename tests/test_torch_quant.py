"""``calibrate``/``quantize``/``dequantize`` of the port against the
JITTED reference (every reference main path runs under ``jax.jit``,
where the calibration divides by multiplying with the float32
reciprocal of qmax): scale, zero point and codes bit for bit."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import quant as ref_quant
from repro_torch.approx import quant as port_quant

_ref_calibrate = jax.jit(functools.partial(ref_quant.calibrate, bits=8))
_ref_quantize = jax.jit(ref_quant.quantize)
_ref_dequantize = jax.jit(ref_quant.dequantize)


def _cases():
    rng = np.random.default_rng(11)
    out = {f"normal{i}": rng.normal(0, rng.uniform(0.01, 5), (37, 29))
           for i in range(6)}
    out["positive"] = rng.uniform(0.1, 3.0, (64, 9))
    out["negative"] = -rng.uniform(0.2, 7.0, (5, 50))
    out["constant_zero"] = np.zeros((8, 8))      # scale hits the eps floor
    out["constant"] = np.full((4, 6), 0.75)
    # values on (near) rounding ties: lo=0, hi=255/8, codes at k+0.5
    out["ties"] = np.concatenate([[0.0, 255 / 8],
                                  (np.arange(0, 254) + 0.5) / 8])[None, :]
    out["tiny_range"] = rng.normal(0, 1e-7, (16, 16))
    return {k: v.astype(np.float32) for k, v in out.items()}


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_calibrate_and_quantize_bit_exact(name):
    x = CASES[name]
    rq = _ref_calibrate(jnp.asarray(x))
    pq = port_quant.calibrate(torch.from_numpy(x))
    assert pq.scale.dtype == torch.float32
    assert pq.zero_point.dtype == torch.int32
    np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(rq.scale))
    np.testing.assert_array_equal(pq.zero_point.numpy(),
                                  np.asarray(rq.zero_point))
    assert pq.qmax == float(rq.qmax) == 255.0
    rc = np.asarray(_ref_quantize(jnp.asarray(x), rq))
    pc = port_quant.quantize(torch.from_numpy(x), pq)
    assert pc.dtype == torch.int32
    np.testing.assert_array_equal(pc.numpy(), rc)
    np.testing.assert_array_equal(
        port_quant.dequantize(pc, pq).numpy(),
        np.asarray(_ref_dequantize(jnp.asarray(rc), rq)))


def test_scale_uses_the_float32_reciprocal():
    """A true f32 division disagrees with jitted JAX on many ranges; the
    port's multiply agrees with it on all of them."""
    rng = np.random.default_rng(5)
    diffs = 0
    for _ in range(200):
        x = rng.normal(0, rng.uniform(0.01, 10), (7,)).astype(np.float32)
        want = np.asarray(_ref_calibrate(jnp.asarray(x)).scale)
        got = port_quant.calibrate(torch.from_numpy(x)).scale.numpy()
        np.testing.assert_array_equal(got, want)
        lo, hi = min(x.min(), 0), max(x.max(), 0)
        diffs += np.float32(hi - lo) / np.float32(255) != want
    assert diffs > 0      # the reciprocal matters on these inputs


def test_lane_calibration_equals_per_lane_reference():
    """lanes=True: each lane of an (n, M, K) tensor calibrates on its own,
    as the reference's vmap lane does."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (4, 13, 7)).astype(np.float32)
    x[1] *= 9.0
    x[2] = np.abs(x[2])
    pq = port_quant.calibrate(torch.from_numpy(x), lanes=True)
    assert tuple(pq.scale.shape) == (4, 1, 1)
    rq = jax.vmap(_ref_calibrate)(jnp.asarray(x))
    np.testing.assert_array_equal(pq.scale.numpy().ravel(),
                                  np.asarray(rq.scale))
    np.testing.assert_array_equal(pq.zero_point.numpy().ravel(),
                                  np.asarray(rq.zero_point))
    codes = port_quant.quantize(torch.from_numpy(x), pq).numpy()
    for i in range(4):
        one = port_quant.calibrate(torch.from_numpy(x[i]))
        np.testing.assert_array_equal(
            codes[i], port_quant.quantize(torch.from_numpy(x[i]),
                                          one).numpy())


def test_scalar_params_and_qmax():
    assert port_quant.qmax_for(8) == 255.0
    assert port_quant.qmax_for(12) == 4095.0
    a = port_quant.calibrate(torch.arange(6.0))
    w = port_quant.calibrate(-torch.arange(6.0))
    sa, za, sw, zw, qmax = port_quant.scalar_params(a, w)
    assert (sa, za, sw, zw, qmax) == (a.scale, a.zero_point, w.scale,
                                      w.zero_point, 255.0)
