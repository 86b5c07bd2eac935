"""The port's training losses (``models.common.chunked_cross_entropy``,
``decoder.forward_train``, ``encdec.forward_train``,
``approx.workload.lm_perplexity``) held against the JAX reference on
the CPU, with the reference's parameters carried across.

Tolerances: the chunked loss within 1e-6; every reduced arch's loss
within 1e-5 relative in f32 (attention, norms and the softmax reduce in
another order than XLA) and 0.04 in bf16 activations (the LM tests'
bf16 bound); ``lm_perplexity`` within 1e-5 of the reference, and a
banked sweep equal to the sequential one bit for bit, its LUT lanes
within ``LUT_RTOL`` of the reference's.  Gradients:
``tests/test_torch_forward_train_grads.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx.layers import EXACT_POLICY as REF_EXACT
from repro.approx import workload as ref_workload
from repro.configs import ARCHS
from repro.models import common as ref_common
from repro.models.common import LMConfig as RefLMConfig
from repro.models.decoder import init_params as ref_init_params
from repro_torch.approx import workload
from repro_torch.approx.dse import explore
from repro_torch.approx.layers import EXACT_POLICY
from repro_torch.core.library import get_default_library
from repro_torch.models import common
from repro_torch.models.common import LMConfig
from repro_torch.models.weights import lm_params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_parity import port_batch, ref_batch, setup

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32_RTOL = 1e-5
BF16_ATOL = 0.04
#: LUT lanes of ``lm_perplexity``: a float difference upstream can move
#: a code on a rounding boundary one step (2e-5 seen on mul8u_exact)
LUT_RTOL = 1e-4


@pytest.mark.parametrize("s,chunk", [(13, 4), (12, 4), (5, 64)])
def test_chunked_cross_entropy_with_padding_and_mask(s, chunk):
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, 8)).astype(np.float32)
    w = rng.standard_normal((17, 8)).astype(np.float32)
    t = rng.integers(0, 17, (2, s)).astype(np.int32)
    m = (rng.random((2, s)) > 0.3).astype(np.float32)
    for mask in (None, m):
        want = ref_common.chunked_cross_entropy(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(t), chunk,
            None if mask is None else jnp.asarray(mask))
        hp = torch.from_numpy(h).requires_grad_(True)
        got = common.chunked_cross_entropy(
            hp, torch.from_numpy(w), torch.from_numpy(t), chunk,
            None if mask is None else torch.from_numpy(mask))
        assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
        got.backward()                     # through the checkpoint
        g = jax.grad(lambda x: ref_common.chunked_cross_entropy(
            x, jnp.asarray(w), jnp.asarray(t), chunk,
            None if mask is None else jnp.asarray(mask)))(jnp.asarray(h))
        np.testing.assert_allclose(hp.grad.numpy(), np.asarray(g),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_loss_matches_reference(arch, dtype):
    jdt = getattr(jnp, dtype)
    rc, pc, rf, pf, rp, pp, b = setup(arch, jdt)
    want = float(jax.jit(lambda p: rf.forward_train(p, ref_batch(b), rc))(
        rp))
    with torch.inference_mode():
        got = pf.forward_train(pp, port_batch(b), pc)
    assert got.shape == () and torch.isfinite(got)
    if dtype == "float32":
        assert abs(float(got) - want) <= F32_RTOL * abs(want), (got, want)
    else:
        assert abs(float(got) - want) <= BF16_ATOL, (got, want)


def _tiny(ns):
    return ns(name="tiny-dense", family="dense", n_layers=2, d_model=32,
              n_heads=2, n_kv_heads=2, d_ff=64, vocab=128, head_dim=16,
              remat=False, loss_chunk=16)


def test_lm_perplexity_banked_equals_sequential_and_reference():
    """The reference's tiny decoder (``tests/test_workload.py``): the
    exact policy within 1e-5 of the reference; a banked all-layers sweep
    over three multipliers equal to the sequential one bit for bit and
    within ``LUT_RTOL`` of the reference's."""
    rc = _tiny(lambda **kw: RefLMConfig(dtype=jnp.float32, **kw))
    pc = _tiny(lambda **kw: LMConfig(dtype=torch.float32, **kw))
    rp = ref_init_params(jax.random.PRNGKey(0), rc)
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp))
    ref = ref_workload.lm_perplexity(rc, rp, batch=2, seq_len=8,
                                     n_batches=2)
    wl = workload.lm_perplexity(pc, pp, batch=2, seq_len=8, n_batches=2,
                                device="cpu")
    assert wl.name == ref.name and wl.metrics == ref.metrics
    assert wl.primary == "perplexity" and wl.primary_direction == "min"
    assert wl.layer_counts == ref.layer_counts
    got, want = wl.measure(EXACT_POLICY), ref.measure(REF_EXACT)
    for k in ("perplexity", "loss"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert got["perplexity"] == pytest.approx(np.exp(got["loss"]),
                                              rel=1e-6)
    lib = get_default_library()
    names = ["mul8u_exact", "mul8u_trunc6", "mul8u_bam_h0_v4"]
    kw = dict(workload=wl, library=lib, multipliers=names, mode="lut",
              per_layer=False)
    banked = explore(batch=True, **kw)
    seq = explore(batch=False, **kw)
    assert ([p.metrics for p in banked.all_layers]
            == [p.metrics for p in seq.all_layers])
    from repro.approx.dse import explore as ref_explore
    ref_rows = ref_explore(workload=ref, library=lib, multipliers=names,
                           mode="lut", per_layer=False, batch=True)
    for p, r in zip(banked.all_layers, ref_rows.all_layers):
        assert p.multiplier == r.multiplier
        assert p.metrics["loss"] == pytest.approx(r.metrics["loss"],
                                                  rel=LUT_RTOL)


def test_lm_perplexity_draws_its_own_weights():
    wl = workload.lm_perplexity("qwen1.5-0.5b", batch=1, seq_len=6,
                                n_batches=1, device="cpu")
    m = wl(EXACT_POLICY)
    assert np.isfinite(m) and m > 1.0
