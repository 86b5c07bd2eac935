"""The port's mesh, placement rules and shape table
(``repro_torch.launch.mesh``, ``repro_torch.configs.shapes``) against the
reference's (``repro.launch.mesh``, ``repro.configs``).

What is held, exactly:
  * ``param_pspec`` for every leaf of ``abstract_params`` of all ten
    archs on the (16, 16) and (2, 16, 16) production meshes and a (1, 1)
    mesh equals the reference's on the reference test's ``FakeMesh``,
    and the leaf paths equal those of ``jax.eval_shape`` of the
    reference's init;
  * ``cache_pspec`` over every decode cell's cache tree, long_500k
    included (the port's ``pos`` is a host int, the reference's an
    array: its spec replicates either way);
  * ``batch_pspec`` with and without microbatches, ``all_cells`` cells
    and skips, ``batch_specs`` shapes and dtypes for every cell and
    ``TUNED_OVERRIDES``;
  * ``bank_pspec`` and the seven leading-axis helpers for counts 1-40 on
    meshes of 1-4 entries (the reference's on a ``jax.sharding.
    AbstractMesh``), and which device takes which slice;
  * DTensor placements on a world-size-1 gloo ``DeviceMesh``.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro import configs as ref_configs
from repro.configs import shapes as ref_shapes
from repro.launch import mesh as ref_mesh
from repro.models.registry import model_fns as ref_model_fns
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.launch import mesh
from repro_torch.models.registry import abstract_params, model_fns
from tests.test_mesh import FakeMesh

MESHES = {"single_pod": ({"data": 16, "model": 16},
                         mesh.make_production_mesh()),
          "multi_pod": ({"pod": 2, "data": 16, "model": 16},
                        mesh.make_production_mesh(multi_pod=True)),
          "one": ({"data": 1, "model": 1},
                  mesh.Mesh(("data", "model"), (1, 1)))}
HELPERS = ("bank_sharding", "slot_sharding", "pop_sharding",
           "policy_sharding", "module_sharding")


def _ref_paths(tree):
    paths, leaves, _ = ref_mesh._tree_with_paths(tree)
    return dict(zip(paths, leaves))


def _port_paths(tree):
    paths, leaves = mesh.tree_with_paths(tree)
    return dict(zip(paths, leaves))


@pytest.fixture(scope="module")
def params_trees():
    """{arch: (reference leaves by path, port leaves by path)}."""
    out = {}
    for arch in configs.ARCHS:
        ref_cfg = ref_configs.get_config(arch)
        ref_tree = jax.eval_shape(partial(ref_model_fns(ref_cfg).init_params,
                                          cfg=ref_cfg), jax.random.PRNGKey(0))
        out[arch] = (_ref_paths(ref_tree),
                     _port_paths(abstract_params(configs.get_config(arch))))
    return out


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_param_leaves_and_rules_equal_reference(arch, params_trees):
    ref_leaves, port_leaves = params_trees[arch]
    assert sorted(port_leaves) == sorted(ref_leaves)
    for path, ref_leaf in ref_leaves.items():
        assert tuple(port_leaves[path].shape) == tuple(ref_leaf.shape), path
    for name, (shape_map, port_mesh) in MESHES.items():
        fake = FakeMesh(shape_map)
        for path, leaf in ref_leaves.items():
            want = tuple(ref_mesh.param_pspec(path, leaf.shape, fake))
            assert mesh.param_pspec(path, tuple(leaf.shape),
                                    port_mesh) == want, (name, path)
        shardings = mesh.params_shardings(
            abstract_params(configs.get_config(arch)), port_mesh)
        for path, sh in _port_paths(shardings).items():
            assert sh.mesh is port_mesh
            assert sh.spec == tuple(ref_mesh.param_pspec(
                path, ref_leaves[path].shape, fake)), (name, path)


def _decode_cells():
    cells, _ = configs.all_cells()
    return [(a, s) for a, s in cells if configs.SHAPES[s].kind == "decode"]


@pytest.mark.parametrize("arch,shape_name", _decode_cells())
def test_cache_rules_equal_reference(arch, shape_name):
    spec = configs.SHAPES[shape_name]
    long_context = shape_name == "long_500k"
    ref_cfg = ref_configs.get_config(arch)
    ref_tree = jax.eval_shape(partial(ref_model_fns(ref_cfg).init_cache,
                                      ref_cfg, spec.global_batch,
                                      spec.seq_len))
    cfg = configs.get_config(arch)
    port_tree = model_fns(cfg).init_cache(cfg, spec.global_batch,
                                          spec.seq_len, "meta")
    ref_leaves, port_leaves = _ref_paths(ref_tree), _port_paths(port_tree)
    assert sorted(port_leaves) == sorted(ref_leaves)
    for shape_map, port_mesh in MESHES.values():
        fake = FakeMesh(shape_map)
        got = _port_paths(mesh.cache_shardings(port_tree, port_mesh,
                                               long_context))
        for path, leaf in ref_leaves.items():
            want = tuple(ref_mesh.cache_pspec(path, leaf.shape, fake,
                                              long_context))
            if path.endswith("pos"):
                # a host int in the port: nothing to place
                assert isinstance(port_leaves[path], int)
                assert got[path].spec == () and set(want) <= {None}
                continue
            assert tuple(port_leaves[path].shape) == tuple(leaf.shape)
            assert mesh.cache_pspec(path, tuple(leaf.shape), port_mesh,
                                    long_context) == want, path
            assert got[path].spec == want, path


def test_cells_skips_overrides_equal_reference():
    assert configs.all_cells() == ref_configs.all_cells()
    cells, skips = configs.all_cells()
    assert len(cells) == 32 and len(skips) == 8
    assert configs.TUNED_OVERRIDES == ref_configs.TUNED_OVERRIDES
    assert list(configs.SHAPES) == list(ref_shapes.SHAPES)
    for name, spec in configs.SHAPES.items():
        assert spec.__dict__ == ref_shapes.SHAPES[name].__dict__
    assert shapes.LONG_CONTEXT_FAMILIES == ref_shapes.LONG_CONTEXT_FAMILIES


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_batch_specs_and_rules_equal_reference(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    dtypes = {torch.int32: jnp.int32, torch.float32: jnp.float32}
    for name, spec in configs.SHAPES.items():
        assert shapes.shape_applicable(cfg, spec) == \
            ref_shapes.shape_applicable(ref_cfg, ref_shapes.SHAPES[name])
        if not shapes.shape_applicable(cfg, spec):
            continue
        want = ref_shapes.batch_specs(ref_cfg, ref_shapes.SHAPES[name])
        got = shapes.batch_specs(cfg, spec)
        on_meta = shapes.batch_specs(cfg, spec, meta=True)
        assert list(got) == list(want)
        for k, sds in want.items():
            assert got[k] == (tuple(sds.shape), got[k][1])
            assert dtypes[got[k][1]] == sds.dtype
            assert on_meta[k].device.type == "meta"
            assert tuple(on_meta[k].shape) == tuple(sds.shape)
            assert on_meta[k].dtype == got[k][1]
        for shape_map, port_mesh in MESHES.values():
            fake = FakeMesh(shape_map)
            sh = mesh.batch_shardings(got, port_mesh)
            for k, sds in want.items():
                ref_spec = tuple(ref_mesh.batch_pspec(k, sds.shape, fake))
                assert sh[k].spec == ref_spec
                # microbatched: a leading microbatch axis of 4
                if sds.shape[0] % 4 == 0:
                    mb = (4, sds.shape[0] // 4) + tuple(sds.shape[1:])
                    assert mesh.batch_pspec(k, mb, port_mesh, True) == \
                        tuple(ref_mesh.batch_pspec(k, mb, fake, True))


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_leading_axis_helpers_equal_reference(n_dev):
    port_mesh = mesh.sweep_mesh(devices=["cpu"] * n_dev)
    ref_abstract = AbstractMesh((n_dev,), ("sweep",))
    for n in range(1, 41):
        want = tuple(ref_mesh.bank_pspec(n, FakeMesh({"sweep": n_dev})))
        assert mesh.bank_pspec(n, port_mesh) == want
        for helper in HELPERS:
            ref_sh = getattr(ref_mesh, helper)(n, ref_abstract)
            port_sh = getattr(mesh, helper)(n, port_mesh)
            assert port_sh.spec == tuple(ref_sh.spec) == want, helper
            assert port_sh.mesh is port_mesh
        ref_bank = ref_mesh.bank_sharding(n, ref_abstract)
        port_bank = mesh.bank_sharding(n, port_mesh)
        assert mesh.lane_sharding(port_bank).spec == \
            tuple(ref_mesh.lane_sharding(ref_bank).spec)
        for rank in (1, 2, 4):
            assert mesh.leading_axis_sharding(port_bank, rank).spec == \
                tuple(ref_mesh.leading_axis_sharding(ref_bank, rank).spec)
        # which device takes which slice: equal slices in order when
        # the spec splits, the whole on the first device otherwise
        got = port_bank.shards(n)
        if want:
            per = n // n_dev
            assert [(s, e) for _d, s, e in got] == \
                [(i * per, (i + 1) * per) for i in range(n_dev)]
        else:
            assert [(s, e) for _d, s, e in got] == [(0, n)]
    assert mesh.bank_pspec(8, port_mesh, axis="data") == ()
    assert mesh.replicated(port_mesh).spec == ()


def test_sweep_mesh_devices_and_no_silent_cpu():
    m = mesh.sweep_mesh(devices=["cpu", "cpu", "cpu"], max_devices=2)
    assert m.axis_names == ("sweep",) and m.shape == {"sweep": 2}
    assert m.devices == (torch.device("cpu"),) * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.sweep_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.bank_sharding(4)
    with pytest.raises(ValueError, match="places nothing"):
        mesh.bank_sharding(16, mesh.make_production_mesh()).shards(16)
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh.Mesh(("sweep",), (4,), (torch.device("cpu"),))


def test_two_axis_mesh_places_along_the_spec_axis():
    """A leading spec naming one axis of a 2 x 2 mesh: slice i goes to
    the device at index i along that axis, 0 along the other."""
    devs = tuple(torch.device("cpu", i) for i in range(4))
    m = mesh.Mesh(("a", "b"), (2, 2), devs)
    got = mesh.NamedSharding(m, ("b",)).shards(6)
    assert got == [(devs[0], 0, 3), (devs[1], 3, 6)]
    got = mesh.NamedSharding(m, ("a",)).shards(6)
    assert got == [(devs[0], 0, 3), (devs[2], 3, 6)]
    got = mesh.NamedSharding(m, (("a", "b"),)).shards(8)
    assert [d for d, _s, _e in got] == list(devs)


def test_dtensor_placements_world_size_one(tmp_path):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        dm = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                        mesh_dim_names=("data", "model"))
        one = MESHES["one"][1]
        cases = {
            ("blocks/mixer_0/wq", (2, 8, 4)): (Shard(1), Shard(2)),
            ("blocks/mixer_0/wo", (2, 8, 4)): (Shard(2), Shard(1)),
            ("final_norm", (8,)): (Replicate(), Replicate()),
        }
        for (path, shape), want in cases.items():
            sh = mesh.NamedSharding(one, mesh.param_pspec(path, shape, one))
            assert sh.placements(dm) == want, path
            t = torch.arange(int(np.prod(shape)),
                             dtype=torch.float32).reshape(shape)
            d = distribute_tensor(t, dm, list(sh.placements(dm)))
            assert torch.equal(d.full_tensor(), t)
        # a tuple of axes shards one dim on both mesh dims, in order
        assert mesh.NamedSharding(one, (("data", "model"), None)) \
            .placements(dm) == (Shard(0), Shard(0))
        with pytest.raises(ValueError, match="out of"):
            mesh.NamedSharding(one, (("model", "data"),)).placements(dm)
        with pytest.raises(ValueError, match="lacks"):
            mesh.NamedSharding(one, ("pod",)).placements(dm)
    finally:
        dist.destroy_process_group()
