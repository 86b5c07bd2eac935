"""Gradients of the port's training paths against ``jax.grad`` of the
reference on the CPU, with the reference's parameters carried across.

``forward_train`` of one reduced arch a family (dense, MoE, hybrid,
MLA, encoder-decoder, VLM): every leaf within 1e-4 of that leaf's
largest |g| in f32; ``remat`` recomputes without changing a bit.
ResNet-8's trainer and STE step: ``tests/test_torch_resnet_train.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ref_opt
from repro_torch.train import optimizer
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_parity import (port_batch, ref_batch, requires_grad,
                                 setup)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRAD_RTOL = 1e-4
FAMILIES = ("qwen1.5-0.5b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
            "deepseek-v2-236b", "whisper-large-v3", "llava-next-34b")


def _port_grads(pf, pp, b, pc) -> tuple:
    pp = requires_grad(pp)
    loss = pf.forward_train(pp, port_batch(b), pc)
    loss.backward()
    return loss.detach(), dict(optimizer.tree_leaves(
        jax.tree.map(lambda t: t.grad, pp,
                     is_leaf=lambda t: isinstance(t, torch.Tensor))))


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_grads_match_reference(arch):
    rc, pc, rf, pf, rp, pp, b = setup(arch)
    loss_r, g_r = jax.jit(jax.value_and_grad(
        lambda p: rf.forward_train(p, ref_batch(b), rc)))(rp)
    loss, grads = _port_grads(pf, pp, b, pc)
    assert abs(float(loss) - float(loss_r)) <= 1e-5 * abs(float(loss_r))
    want = dict(ref_opt._tree_paths(g_r))
    assert list(grads) == list(want)
    for k, g in grads.items():
        ref = np.asarray(want[k])
        scale = max(float(np.max(np.abs(ref))), 1e-12)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "whisper-large-v3"])
def test_remat_changes_no_gradient(arch):
    _, pc, _, pf, _, pp, b = setup(arch)
    _, plain = _port_grads(pf, pp, b, pc)
    _, pc2, _, pf2, _, pp2, _ = setup(arch)
    _, remat = _port_grads(pf2, pp2, b, dataclasses.replace(pc2,
                                                            remat=True))
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k
