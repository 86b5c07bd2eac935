"""The legacy ``MatmulBackend`` shim (``repro_torch.approx.backend``)
against the reference's (``repro.approx.backend``).

  * ``to_spec`` equals the reference's for the same fields;
  * ``from_library`` warns ``DeprecationWarning`` and packs the
    reference's LUT and low-rank factors;
  * ``as_backend(MatmulBackend(...))`` computes what the spec computes,
    bit for bit, on int8, LUT (hand-attached and from the library, under
    ``ref`` and ``pallas``, whose plain version the CPU runs) and
    low-rank; an ``ApproxPolicy`` takes one, serializes its spec and
    salts its cache key with a backend that carries arrays.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.approx import backend as ref_backend
from repro_torch.approx import MatmulBackend, as_backend, backend_matmul
from repro_torch.approx.layers import ApproxPolicy, spec_of
from repro_torch.approx.specs import BackendSpec
from repro_torch.core.library import get_default_library

FIELDS = [dict(), dict(mode="int8"), dict(mode="lut", multiplier="m1"),
          dict(mode="lowrank", multiplier="m2", rank=4, block_m=64),
          dict(mode="lut", ste=False, use_pallas=True),
          dict(mode="f32", rank=0)]


@pytest.mark.parametrize("fields", FIELDS)
def test_to_spec_equals_the_reference(fields):
    port = MatmulBackend(**fields).to_spec()
    ref = ref_backend.MatmulBackend(**fields).to_spec()
    assert port.to_dict() == ref.to_dict()
    assert spec_of(MatmulBackend(**fields)) == port


def _mult():
    lib = get_default_library()
    return next(e.name for e in lib.pareto_front("multiplier", 8, "mae")
                if e.source != "exact")


def test_from_library_warns_and_packs_the_reference_arrays():
    name = _mult()
    with pytest.warns(DeprecationWarning):
        port = MatmulBackend.from_library(name, mode="lowrank", rank=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = ref_backend.MatmulBackend.from_library(name, mode="lowrank",
                                                     rank=4)
    np.testing.assert_array_equal(port.lut, np.asarray(ref.lut))
    np.testing.assert_allclose(port.factors_u, np.asarray(ref.factors_u),
                               rtol=1e-6, atol=1e-6)
    assert port.rank == ref.rank == 4


def _xw():
    rng = np.random.default_rng(3)
    return (torch.from_numpy(rng.standard_normal((6, 40), np.float32)),
            torch.from_numpy(rng.standard_normal((40, 9), np.float32)))


@pytest.mark.parametrize("mode,variant", [("int8", "ref"), ("lut", "ref"),
                                          ("lut", "pallas"),
                                          ("lowrank", "ref"),
                                          ("lowrank", "pallas")])
def test_legacy_backend_computes_what_the_spec_computes(mode, variant):
    x, w = _xw()
    name = "mul8u_exact" if mode == "int8" else _mult()
    spec = BackendSpec(mode=mode, multiplier=name, rank=4,
                       variant=variant)
    want = backend_matmul(x, w, spec)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = (MatmulBackend(mode="int8") if mode == "int8" else
                  MatmulBackend.from_library(
                      name, mode=mode, rank=4,
                      use_pallas=variant == "pallas"))
    assert torch.equal(backend_matmul(x, w, legacy), want)
    assert torch.equal(ApproxPolicy(default=legacy).matmul("l", x, w),
                       want)


def test_hand_attached_lut_and_policy_keys():
    x, w = _xw()
    a = np.arange(256, dtype=np.int64)
    exact = (a[:, None] * a[None, :]).astype(np.int32)
    legacy = MatmulBackend(mode="lut", multiplier="hand", lut=exact)
    want = backend_matmul(x, w, BackendSpec(mode="int8"))
    assert torch.equal(backend_matmul(x, w, legacy), want)
    mb = as_backend(legacy)
    assert not mb.canonical and mb.spec.multiplier == "hand"
    policy = ApproxPolicy(default=legacy)
    assert policy.cache_key()[0][1] is legacy
    assert policy.to_json_dict()["default"]["multiplier"] == "hand"
    assert policy.materialize().default.consts["lut"] is not None
    assert ApproxPolicy(default=MatmulBackend(mode="int8")).cache_key() \
        == ApproxPolicy(default=BackendSpec(mode="int8")).cache_key()
    with pytest.raises(ValueError, match="without a LUT"):
        as_backend(MatmulBackend(mode="lut"))
