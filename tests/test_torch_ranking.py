"""The port's rank statistics (``repro_torch.approx.ranking``) against
the JAX package's (``repro.approx.ranking``) on the reference test's
cases (tests/test_ranking.py): ties, tied groups, constants, random
vectors.  Both are float64 numpy, so every result is held bit for bit
(``nan`` where the reference gives ``nan``), and the same inputs
raise."""
import numpy as np
import pytest

from repro.approx import ranking as ref
from repro_torch.approx import ranking as port

CASES = [
    [1.0, 2.0, 3.0, 4.0, 5.0],
    [5.0, 3.0, 1.0, 4.0, 2.0],
    [1.0, 2.0, 2.0, 3.0],            # interior tie
    [0.0, 0.0, 1.0, 1.0, 2.0],       # tied groups
    [3.5, -1.0, 2.0, 2.0, 2.0, 9.0],
    list(np.random.default_rng(0).normal(size=12)),
    list(np.random.default_rng(1).integers(0, 4, size=10).astype(float)),
    [2.0, 2.0, 2.0, 2.0],            # constant
]


def _same(got, want):
    """Bit-equal floats, ``nan`` matching ``nan``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("x", CASES)
def test_rankdata_equals_reference(x):
    _same(port.rankdata(x), ref.rankdata(x))


@pytest.mark.parametrize("i", range(len(CASES)))
@pytest.mark.parametrize("fn", ["spearman", "kendall"])
def test_correlations_equal_reference(fn, i):
    """Every case against every case of its length (and the reference
    test's truncated pairs)."""
    x = CASES[i]
    pairs = [(x, y) for y in CASES if len(y) == len(x)]
    pairs += [(x[:len(y)], y[:len(x)]) for y in CASES]
    for a, b in pairs:
        got = getattr(port, fn)(a, b)
        want = getattr(ref, fn)(a, b)
        assert isinstance(got, float)
        _same(got, want)


def test_nan_cases_equal_reference():
    for fn in ("spearman", "kendall"):
        for a, b in (([1.0, 1.0, 1.0], [1.0, 2.0, 3.0]),
                     ([1.0, 2.0, 3.0], [2.0, 2.0, 2.0]),
                     ([1.0], [2.0]), ([], [])):
            got, want = getattr(port, fn)(a, b), getattr(ref, fn)(a, b)
            assert np.isnan(want) and np.isnan(got)


def test_per_layer_spearman_equals_reference():
    rng = np.random.default_rng(7)
    pred = rng.normal(size=(4, 9))
    meas = pred + 0.5 * rng.normal(size=(4, 9))
    pred[2] = 1.0                      # a constant row gives nan
    meas[3, :3] = meas[3, 3]           # ties
    layers = ["a", "b", "c", "d"]
    got = port.per_layer_spearman(pred, meas, layers)
    want = ref.per_layer_spearman(pred, meas, layers)
    assert list(got) == list(want)
    for k in layers:
        _same(got[k], want[k])


def test_same_inputs_raise():
    for mod in (port, ref):
        with pytest.raises(ValueError, match="length mismatch"):
            mod.spearman([1.0, 2.0], [1.0, 2.0, 3.0])
        with pytest.raises(ValueError, match="length mismatch"):
            mod.kendall([1.0, 2.0], [1.0])
        with pytest.raises(ValueError, match="1-d"):
            mod.rankdata(np.zeros((2, 2)))
        with pytest.raises(ValueError, match="shape mismatch"):
            mod.per_layer_spearman(np.zeros((3, 2)), np.zeros((2, 2)),
                                   ["a", "b", "c"])
