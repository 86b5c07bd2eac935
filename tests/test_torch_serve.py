"""The static-batch serving path of the port against the reference's:
``Engine.generate`` tokens, per-request policies in JSON across the two
packages, temperature sampling and the serve CLI on the CPU (static and
``--continuous``).

Token parity.  Under ``f32`` the greedy tokens equal the reference
``Engine``'s.  Under the quantized policies a last-bit difference can
move a quantization code (``tests/test_torch_lm.py``: the logits agree
within ``QUANT_RTOL`` = 0.025 of the largest |logit|), so a greedy token
must equal the reference's wherever the reference's top-1/top-2 logit
margin exceeds that tolerance.  At the first step of a row whose margin does not, the
row is reported (printed, and counted in the assertion message) and
not compared further, since the two streams may part there."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx.layers import ApproxPolicy as RefPolicy
from repro.approx.specs import BackendSpec as RefSpec
from repro.configs import get_config as ref_get_config
from repro.core.library import build_default_library as ref_build
from repro.models.common import LMConfig as RefLMConfig
from repro.models.registry import model_fns as ref_model_fns
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.approx.layers import EXACT_POLICY, ApproxPolicy
from repro_torch.approx.specs import BackendSpec
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.steps import pick_case_multiplier, serve_policy
from repro_torch.models.common import LMConfig
from repro_torch.models.weights import lm_params_from_numpy
from repro_torch.serve import Engine, ServeConfig

QUANT_RTOL = 0.025
B, S, N = 4, 8, 6


def _configs():
    kw = dict(name="tiny-dense", family="dense", n_layers=2, d_model=32,
              n_heads=2, n_kv_heads=2, d_ff=64, vocab=128, head_dim=16,
              remat=False, loss_chunk=16)
    return {"tiny": (RefLMConfig(dtype=jnp.float32, **kw),
                     LMConfig(dtype=torch.float32, **kw)),
            "reduced": (ref_get_config("qwen1.5-0.5b").reduced(),
                        get_config("qwen1.5-0.5b").reduced())}


@pytest.fixture(scope="module")
def setup():
    lib = ref_build("tiny")
    out = {}
    for name, (ref_cfg, cfg) in _configs().items():
        params = jax.tree.map(np.asarray, ref_model_fns(
            ref_cfg).init_params(jax.random.PRNGKey(0), ref_cfg))
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, (B, S)).astype(np.int32)
        out[name] = (ref_cfg, cfg, params, prompts)
    return lib, out


def _policies(lib):
    mult = pick_case_multiplier(lib)
    return {
        "f32": (RefSpec(mode="f32"), BackendSpec(mode="f32")),
        "int8": (RefSpec(mode="int8"), BackendSpec(mode="int8")),
        "lowrank_ref": (RefSpec(mode="lowrank", multiplier=mult, rank=4),
                        BackendSpec(mode="lowrank", multiplier=mult,
                                    rank=4)),
        "lowrank_pallas": (
            RefSpec(mode="lowrank", multiplier=mult, rank=4),
            BackendSpec(mode="lowrank", multiplier=mult, rank=4,
                        variant="pallas")),
    }


def _ref_margins(ref_cfg, params, prompts, spec, lib):
    """The reference's greedy tokens (B, N), its top-1/top-2 logit
    margins at each step and its largest |logit|, from its jitted
    prefill/decode."""
    fns = ref_model_fns(ref_cfg)
    pol = RefPolicy(default=spec).materialize(lib)
    pre = jax.jit(lambda p, b, c: fns.forward_prefill(p, b, c, ref_cfg,
                                                      pol))
    dec = jax.jit(lambda p, t, c: fns.forward_decode(p, t, c, ref_cfg,
                                                     pol))
    cache = fns.init_cache(ref_cfg, B, S + N)
    logits, cache = pre(params, {"tokens": jnp.asarray(prompts)}, cache)
    toks, margins, scale = [], [], 0.0
    for i in range(N):
        if i:
            logits, cache = dec(params, jnp.asarray(toks[-1]), cache)
        lg = np.asarray(logits)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        toks.append(lg.argmax(-1).astype(np.int32))
        scale = max(scale, float(np.abs(lg).max()))
    return np.stack(toks, 1), np.stack(margins, 1), scale


@pytest.mark.parametrize("policy", ["f32", "int8", "lowrank_ref",
                                    "lowrank_pallas"])
@pytest.mark.parametrize("cname", ["tiny", "reduced"])
def test_greedy_tokens_match_reference_engine(setup, cname, policy):
    lib, cfgs = setup
    ref_cfg, cfg, params, prompts = cfgs[cname]
    ref_spec, spec = _policies(lib)[policy]
    want = RefEngine(ref_cfg, jax.tree.map(jnp.asarray, params), RefPolicy(
        default=ref_spec), library=lib).generate(
            prompts, RefServeConfig(max_new_tokens=N))
    got = Engine(cfg, lm_params_from_numpy(params), ApproxPolicy(
        default=spec), library=lib).generate(prompts,
                                             ServeConfig(max_new_tokens=N))
    assert got.shape == want.shape == (B, N) and got.dtype == np.int32
    if policy == "f32":
        np.testing.assert_array_equal(got, want)
        return
    toks, margins, scale = _ref_margins(
        ref_cfg, jax.tree.map(jnp.asarray, params), prompts, ref_spec, lib)
    np.testing.assert_array_equal(toks, want)
    tol = QUANT_RTOL * scale
    unresolved, compared = [], 0
    for row in range(B):
        for step in range(N):
            if margins[row, step] <= tol:
                unresolved.append((row, step, float(margins[row, step]),
                                   bool(got[row, step] == want[row, step])))
                break
            assert got[row, step] == want[row, step], (row, step, margins)
            compared += 1
    print(f"{cname}/{policy}: {int((got == want).sum())} of {B * N} tokens "
          f"equal, {compared} compared; rows "
          f"not compared past a margin <= {tol:.4g} (row, step, margin, "
          f"equal there): {unresolved}")
    assert compared >= B, f"{compared} tokens compared: {unresolved}"


def test_request_policy_json_round_trips_between_packages(setup):
    lib, cfgs = setup
    ref_cfg, cfg, params, prompts = cfgs["tiny"]
    mult = pick_case_multiplier(lib)
    ref_policy = RefPolicy(
        default=RefSpec(mode="int8"),
        overrides=[("attn.*", RefSpec(mode="lowrank", multiplier=mult,
                                      rank=4, variant="pallas"))])
    text = ref_policy.to_json()
    engine = Engine(cfg, lm_params_from_numpy(params), library=lib)
    port_policy = ApproxPolicy.from_json(text)
    assert port_policy.to_json() == text
    assert RefPolicy.from_json(port_policy.to_json_dict()).to_json() == text
    for request in (text, json.loads(text)):
        got = engine.generate(prompts, ServeConfig(max_new_tokens=3,
                                                   policy=request))
        want = Engine(cfg, engine.params, port_policy, library=lib).generate(
            prompts, ServeConfig(max_new_tokens=3))
        np.testing.assert_array_equal(got, want)
    # the engine default stays untouched by a per-request policy
    assert engine.policy.to_json() == EXACT_POLICY.to_json()


def test_temperature_sampling_is_seeded(setup):
    lib, cfgs = setup
    _, cfg, params, prompts = cfgs["tiny"]
    engine = Engine(cfg, lm_params_from_numpy(params), library=lib)
    runs = [engine.generate(prompts, ServeConfig(
        max_new_tokens=4, temperature=1.5, seed=seed)) for seed in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert ((runs[0] >= 0) & (runs[0] < cfg.vocab)).all()


def test_serve_policy_defaults_to_the_kernel_variant(setup):
    lib, _ = setup
    pol = serve_policy()
    assert pol.default.spec.datapath_name == "lowrank_pallas"
    assert pol.default.spec.rank == 4
    assert serve_policy(variant="ref").default.spec.datapath_name \
        == "lowrank"
    assert serve_policy(mode="int8").default.spec.mode == "int8"


def test_serve_run_on_the_cpu(capsys):
    record = serve.run(device="cpu", reduced=True, batch=2, prompt_len=8,
                       max_new=4, log=print)
    assert np.asarray(record["tokens"]).shape == (2, 4)
    assert record["variant"] == "pallas" and record["mode"] == "lowrank"
    assert record["multiplier"] == pick_case_multiplier()
    for key in ("warmup_s", "e2e_s", "prefill_s", "tok_per_s",
                "decode_tok_per_s"):
        assert record[key] > 0, key
    assert "steady-state decode" in capsys.readouterr().out
    serve.main(["--device", "cpu", "--reduced", "--batch", "2",
                "--prompt-len", "8", "--max-new", "2", "--no-warmup",
                "--mode", "int8"])
    assert "mode=int8" in capsys.readouterr().out
    serve.main(["--device", "cpu", "--reduced", "--batch", "3",
                "--prompt-len", "5", "--max-new", "3", "--continuous"])
    out = capsys.readouterr().out
    assert "continuous n_slots=3 variant=pallas generated 9 tokens" in out
    assert "bank_builds=1" in out
    record = serve.run(device="cpu", reduced=True, batch=2, prompt_len=4,
                       max_new=3, variant="fused", continuous=True,
                       log=print)
    assert record["continuous"] and record["mode"] == "lut"
    assert [len(t) for t in record["tokens"].values()] == [3, 3]
    assert record["n_slots"] == 2 and record["capacity"] == 7
    assert record["decode_steps"] == 3 and record["bank_builds"] == 1
    for kind, n in (("prefill", 2), ("decode", 2)):
        assert record["steps"][kind]["n"] == n
        assert record["steps"][kind]["banked"] == [7 * 2]
        assert record["steps"][kind]["single"] == [0]
