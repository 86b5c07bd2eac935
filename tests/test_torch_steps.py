"""The port's cell and probe functions (``repro_torch.launch.steps``)
against the reference's (``repro.launch.steps``).

For every cell of ``all_cells()`` — with and without
``TUNED_OVERRIDES``, and under ``serve_mode="lowrank_prepared"`` — the
argument trees of ``build_cell`` and of each ``build_probes`` probe
(meta tensors in the port, ``jax.eval_shape`` trees in the reference)
are equal leaf by leaf: paths, shapes and dtypes (the port's host
``pos``, one int a cache, stands for the reference's int32 ``pos``, a
scalar or one a stacked layer group).  ``kind``, ``donate``,
``microbatches``, probe names and depths are equal, and ``param_count``
and ``model_flops`` are equal exactly.  The reference's ``jax.eval_shape``
is memoized per (function, arguments) in this file, so each arch's trees
are traced once.
"""
import functools

import jax
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro_torch import configs
from repro_torch.launch import steps
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DP = 16
_EVAL_CACHE: dict = {}
_real_eval_shape = jax.eval_shape


def _cached_eval_shape(fn, *args, **kwargs):
    """``jax.eval_shape`` memoized on a ``functools.partial``'s function
    and arguments (``build_cell`` makes a new partial each call)."""
    if not isinstance(fn, functools.partial):
        return _real_eval_shape(fn, *args, **kwargs)
    try:
        key = (fn.func, fn.args, tuple(sorted(fn.keywords.items())),
               tuple(getattr(a, "shape", a) for a in args))
        hash(key)
    except TypeError:
        return _real_eval_shape(fn, *args, **kwargs)
    if key not in _EVAL_CACHE:
        _EVAL_CACHE[key] = _real_eval_shape(fn, *args, **kwargs)
    return _EVAL_CACHE[key]


@pytest.fixture(autouse=True)
def memo_eval_shape(monkeypatch):
    monkeypatch.setattr(ref_steps.jax, "eval_shape", _cached_eval_shape)


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
        if key.endswith("/pos") and out[key][1] == "int32":
            out[key] = "pos"
    return out


def _port_leaves(tree, prefix="") -> dict:
    sep = "/" if prefix else ""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_leaves(tree[k], f"{prefix}{sep}{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_port_leaves(getattr(tree, f), f"{prefix}{sep}.{f}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, f"{prefix}{sep}{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta", prefix
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).replace("torch.", ""))}
    assert isinstance(tree, int) and prefix.endswith("/pos"), prefix
    return {prefix: "pos"}                   # a cache's host pos


def _same_cell(port, ref):
    assert port.kind == ref.kind
    assert port.donate == ref.donate
    assert port.microbatches == ref.microbatches
    assert port.arch == ref.arch and port.shape.name == ref.shape.name
    assert _port_leaves(port.args_sds) == _ref_leaves(ref.args_sds)


def _variants(arch):
    """(overrides, serve_mode) pairs of this arch's cells."""
    out = [(None, "lowrank"), (None, "lowrank_prepared")]
    if arch in configs.TUNED_OVERRIDES:
        out.append((configs.TUNED_OVERRIDES[arch], "lowrank"))
    return out


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_cells_and_probes_equal_the_reference(arch):
    cells = [s for a, s in configs.all_cells()[0] if a == arch]
    assert cells == [s for a, s in ref_configs.all_cells()[0] if a == arch]
    for shape in cells:
        for overrides, mode in _variants(arch):
            if mode == "lowrank_prepared" and shape == "train_4k":
                continue                 # prepared trees serve only
            kw = dict(serve_mult="mul8u_exact", serve_mode=mode,
                      overrides=overrides, serve_rank=4)
            port = steps.build_cell(arch, shape, DP, **kw)
            ref = ref_steps.build_cell(arch, shape, DP, **kw)
            _same_cell(port, ref)
            assert steps.param_count(port.args_sds[0], port.cfg) == \
                ref_steps.param_count(ref.args_sds[0], ref.cfg)
            assert steps.model_flops(port, port.args_sds[0]) == \
                ref_steps.model_flops(ref, ref.args_sds[0])
            pp = steps.build_probes(arch, shape, DP, **kw)
            rp = ref_steps.build_probes(arch, shape, DP, **kw)
            assert [(p.name, p.depth) for p in pp] == \
                [(p.name, p.depth) for p in rp]
            for p, r in zip(pp, rp):
                _same_cell(p.cell, r.cell)
                assert _port_leaves(p.args_sds) == _ref_leaves(r.args_sds)
                assert p.cell.cfg.n_layers == r.cell.cfg.n_layers
                assert p.cell.cfg.n_enc_layers == r.cell.cfg.n_enc_layers
                assert p.cell.cfg.scan_unroll == r.cell.cfg.scan_unroll


def test_cells_on_other_data_parallel_sizes():
    """Microbatch counts follow the data-parallel size (1, 2, 32)."""
    for dp in (1, 2, 32):
        port = steps.build_cell("qwen1.5-0.5b", "train_4k", dp)
        ref = ref_steps.build_cell("qwen1.5-0.5b", "train_4k", dp)
        _same_cell(port, ref)


def test_apply_overrides_types():
    port = configs.get_config("qwen3-moe-30b-a3b")
    ref = ref_configs.get_config("qwen3-moe-30b-a3b")
    ov = {"moe_blocks": "16", "capacity_factor": "1.0", "remat": "false",
          "attn_impl": "chunked", "qk_norm": True, "kv_chunk": 512}
    a = steps.apply_overrides(port, ov)
    b = ref_steps.apply_overrides(ref, ov)
    for k in ov:
        assert getattr(a, k) == getattr(b, k), k
        assert type(getattr(a, k)) is type(getattr(b, k)), k
    assert steps.apply_overrides(port, None) is port
    assert steps.apply_overrides(port, {}) is port


def test_param_count_of_a_hand_tree():
    """The counting rules on a hand-made tree: aux leaves skipped, tabs
    counted as their K x N weight, experts scaled by top_k / E, embed
    and unembed only in the total."""
    cfg = configs.get_config("qwen3-moe-30b-a3b")
    e, k = cfg.n_experts, cfg.top_k
    meta = {"embed": torch.empty(10, 4, device="meta"),
            "blocks": {"ffn_0": {"wi": torch.empty(2, e, 4, 8,
                                                   device="meta")},
                       "mixer_0": {"wq": {"tabs": torch.empty(
                           2, 3, 4, 8, device="meta"),
                           "colsum": torch.empty(2, 8, device="meta")}}}}
    total, active = steps.param_count(meta, cfg)
    assert total == 40 + 2 * e * 32 + 2 * 32
    assert active == int(2 * e * 32 * k / e) + 2 * 32
