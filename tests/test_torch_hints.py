"""The port's sharding hints (``repro_torch.models.common.hint_*``)
against the reference's (``repro.models.common``).

  * without an ambient mesh each hint returns its input object (a plain
    tensor under a mesh too);
  * the spec a hint builds (``hint_pspec``) equals the one the
    reference's hint hands ``with_sharding_constraint``, for the
    reference's call shapes on the (16, 16), (2, 16, 16) and (1, 1)
    meshes, and so do their DTensor placements;
  * on a single-rank gloo group with a (1, 1) mesh, a hinted DTensor
    lands on those placements, and a tiny decoder's prefill and
    training loss with parameters and batch as DTensors under the mesh
    (hints active) are bit-equal to the plain forward without one.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models import common as ref_common
from repro_torch.approx.specs import BackendSpec
from repro_torch.approx.layers import ApproxPolicy
from repro_torch.launch import mesh
from repro_torch.models import common
from repro_torch.models.common import (LMConfig, ambient_mesh, hint_axis,
                                       hint_batch, hint_pspec, hint_spec)
from repro_torch.models.registry import model_fns
from tests.test_mesh import FakeMesh
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 1, "model": 1}, {"model": 4}]
#: (shape, dims) of every call site: activations after the embedding
#: and each layer (B, S, D), a decode step's (B, 1, D), the MoE buffer
#: (E, C, D), and dims that do not divide
CASES = [((256, 4096, 1024), {0: "batch"}), ((32, 1, 64), {0: "batch"}),
         ((1, 8, 64), {0: "batch"}), ((128, 32, 2048), {0: "model"}),
         ((60, 40, 512), {0: "model"}), ((24, 16, 8), {0: "batch",
                                                       2: "model"}),
         ((6, 7), {0: "batch", 1: "model"}), ((48, 3), {1: "nope"})]


class _Named:
    """What ``NamedSharding.placements`` reads of a ``DeviceMesh``."""

    def __init__(self, names):
        self.mesh_dim_names = tuple(names)
        self.ndim = len(names)


def _ref_spec(monkeypatch, axes: dict, shape, dims):
    """The PartitionSpec the reference's ``hint_spec`` constrains to
    under a mesh of ``axes`` (None when it returns its input)."""
    import jax
    import jax.numpy as jnp
    got = []
    monkeypatch.setattr(ref_common, "_ambient_mesh",
                        lambda: FakeMesh(axes))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: got.append(tuple(s)) or x)
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    out = ref_common.hint_spec(x, dims)
    return got[0] if got else (None if out is x else "changed")


def test_without_a_mesh_hints_return_their_input():
    x = torch.randn(4, 3, 2)
    assert hint_batch(x) is x
    assert hint_axis(x, 1) is x
    assert hint_spec(x, {0: "batch", 2: "model"}) is x


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
def test_hint_specs_equal_the_reference(monkeypatch, axes):
    names, sizes = tuple(axes), tuple(axes.values())
    desc = mesh.Mesh(names, sizes)
    for shape, dims in CASES:
        want = _ref_spec(monkeypatch, axes, shape, dims)
        got = hint_pspec(shape, dims, names, sizes)
        assert got == want, (shape, dims)
        if got is not None:
            assert mesh.NamedSharding(desc, got).placements(
                _Named(names)) == mesh.NamedSharding(desc, want) \
                .placements(_Named(names))
    # hint_batch and hint_axis are hint_spec of one dim
    monkeypatch.setattr(ref_common, "hint_spec",
                        lambda x, d: ("spec", d))
    assert ref_common.hint_axis(None, 2, "model") == ("spec", {2: "model"})


@pytest.fixture
def gloo_one(tmp_path):
    from torch.distributed.device_mesh import DeviceMesh
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                         mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _dtensors(tree, dm):
    from torch.distributed.tensor import Replicate, distribute_tensor
    if isinstance(tree, dict):
        return {k: _dtensors(v, dm) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, dm, [Replicate(), Replicate()])
    return tree


def _plain(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def test_hints_place_dtensors_on_a_one_rank_mesh(gloo_one):
    from torch.distributed.tensor import Replicate, Shard
    dm = gloo_one
    x = _dtensors(torch.randn(4, 6, 8), dm)
    with ambient_mesh(dm):
        y = hint_batch(x)
        assert y.placements == (Shard(0), Replicate())
        z = hint_spec(x, {0: "batch", 2: "model"})
        assert z.placements == (Shard(0), Shard(2))
        assert hint_axis(x, 1).placements == (Replicate(), Shard(1))
        plain = torch.randn(3)
        assert hint_batch(plain) is plain
        assert torch.equal(_plain(z), _plain(x))
    assert common._ambient_mesh() is None


TINY = LMConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, head_dim=8,
                remat=False, loss_chunk=8, dtype=torch.float32)


@pytest.mark.parametrize("policy", [
    ApproxPolicy(), ApproxPolicy(default=BackendSpec(
        mode="lowrank", multiplier="mul8u_exact", rank=4, variant="ref"))],
    ids=["f32", "lowrank"])
def test_tiny_decoder_is_bit_equal_with_hints(gloo_one, policy):
    from torch.distributed.tensor.experimental import implicit_replication
    dm = gloo_one
    fns = model_fns(TINY)
    gen = torch.Generator().manual_seed(0)
    params = fns.init_params(gen, TINY)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 64, (2, 8), dtype=np.int32))
    tgts = torch.from_numpy(rng.integers(0, 64, (2, 8), dtype=np.int32))
    with torch.no_grad():
        want_logits, _ = fns.forward_prefill(
            params, {"tokens": toks}, fns.init_cache(TINY, 2, 9), TINY,
            policy)
        want_loss = fns.forward_train(params, {"tokens": toks,
                                               "targets": tgts}, TINY)
        with ambient_mesh(dm), implicit_replication():
            dparams = _dtensors(params, dm)
            cache = _dtensors(fns.init_cache(TINY, 2, 9), dm)
            logits, _ = fns.forward_prefill(
                dparams, {"tokens": _dtensors(toks, dm)}, cache, TINY,
                policy)
            loss = fns.forward_train(dparams, _dtensors(
                {"tokens": toks, "targets": tgts}, dm), TINY)
    assert torch.equal(_plain(logits), want_logits)
    assert torch.equal(_plain(loss), want_loss)
