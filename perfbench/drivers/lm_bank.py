"""Banked resilience sweeps of an MoE decoder LM: one pass evaluates the
training loss of one token batch under every candidate multiplier of
the bank, as ``approx.workload.lm_perplexity`` does.

Parameters (the workload file): ``lanes`` (names of ``data/mult8.npz``),
``batch`` sequences of ``seq_len`` tokens a pass, ``pool_batches``
distinct batches of uniform token ids made from the seed and used in a
seeded order, ``mode`` and ``variant`` of the banked datapath (every
attention and routed-expert projection banked), ``check_passes``,
``trace_passes`` and ``limits``.

The configuration file gives the published sizes; the weights are drawn
on the device from the seed in a few large calls, in f32, and handed to
the program and to the reference alike.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import counts, tables
from perfbench.spans import pass_scope
from perfbench.reference import decoder_moe as ref

#: leaves drawn at scale 0.02; leaves named ``*norm*`` are ones; the rest
#: normal / sqrt(fan_in)
SMALL_LEAVES = ("embed", "unembed", "router")


def model_config(config: dict) -> dict:
    """The model's sizes as the port and the reference name them."""
    port = config["port"]
    return {
        "name": config["name"], "family": port["family"],
        "n_layers": config["num_hidden_layers"],
        "d_model": config["hidden_size"],
        "n_heads": config["num_attention_heads"],
        "n_kv_heads": config["num_key_value_heads"],
        "head_dim": config["head_dim"],
        "d_ff": config["moe_intermediate_size"],
        "moe_d_ff": config["moe_intermediate_size"],
        "vocab": config["vocab_size"],
        "qk_norm": port["qk_norm"], "act": config["hidden_act"],
        "n_experts": config["num_experts"],
        "top_k": config["num_experts_per_tok"],
        "rope_theta": config["rope_theta"],
        "norm_eps": config["rms_norm_eps"],
        "capacity_factor": port["capacity_factor"],
    }


def draw_weights(shapes: dict, seed: int, device) -> dict:
    """A parameter tree of f32 tensors with the nested ``shapes``: one
    flat buffer filled from the seed in chunks of 2^30 values, then each
    leaf a view of it, scaled."""
    leaves = []

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                leaves.append((path + (k,), tuple(v)))
    walk(shapes, ())
    total = sum(math.prod(s) for _, s in leaves)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    step = 1 << 30
    for i in range(0, total, step):
        flat[i:i + step].normal_(generator=gen)
    tree: dict = {}
    off = 0
    for path, shape in leaves:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        name = path[-1]
        if "norm" in name:
            t.fill_(1.0)
        elif name in SMALL_LEAVES:
            t.mul_(0.02)
        else:
            t.mul_(1.0 / np.sqrt(shape[-2]))
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[name] = t
    return tree


def decoder_shapes(c: dict) -> dict:
    """The parameter tree's shapes in the program's layout
    (``models.decoder.init_params``) for a decoder of one attention and
    one MoE block a layer, every layer stacked on a leading axis."""
    if c["family"] != "moe":
        raise ValueError(f"lm_bank draws moe decoders, not "
                         f"{c['family']!r}")
    g, d, e = c["n_layers"], c["d_model"], c["n_experts"]
    h, hk, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    mixer = {"wq": (g, d, h * hd), "wk": (g, d, hk * hd),
             "wv": (g, d, hk * hd), "wo": (g, h * hd, d)}
    if c["qk_norm"]:
        mixer.update(qnorm=(g, hd), knorm=(g, hd))
    f = c["moe_d_ff"]
    ffn = {"router": (g, d, e), "wi": (g, e, d, f), "wo": (g, e, f, d),
           "wg": (g, e, d, f)}
    return {"embed": (c["vocab"], d), "final_norm": (d,),
            "unembed": (c["vocab"], d),
            "blocks": {"mixer_0": mixer, "norm1_0": (g, d), "ffn_0": ffn,
                       "norm2_0": (g, d)}}


class LmBank:
    def __init__(self, spec, config, seed, device, root):
        from repro_torch.approx.layers import bank_eval
        from repro_torch.approx.specs import LutBank
        from repro_torch.models.common import LMConfig
        from repro_torch.models.registry import model_fns

        self.spec, self.device = spec, device
        self.mcfg = model_config(config)
        self.aux_coef = config["port"]["aux_loss_coef"]
        dtype = getattr(torch, config["port"]["dtype"])
        self.cfg = LMConfig(**self.mcfg, dtype=dtype)
        self.fns = model_fns(self.cfg)
        t0 = time.perf_counter()
        self.params = draw_weights(decoder_shapes(self.mcfg), seed, device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_log = {"weights_s": time.perf_counter() - t0}
        self.names, self.luts = tables.load(root, spec["lanes"])
        self.bank = LutBank(names=tuple(self.names), luts=self.luts)
        b, s = spec["batch"], spec["seq_len"]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 1)
        self.pool = torch.randint(0, self.cfg.vocab,
                                  (spec["pool_batches"], b, s + 1),
                                  generator=gen, device=device,
                                  dtype=torch.int32)
        self.order = np.random.default_rng(seed).permutation(
            spec["pool_batches"])
        n = len(self.names)
        self.units = {"lane_tokens": n * b * s}
        c = self.mcfg
        projs = counts.moe_decoder_projections(
            b * s, c["n_layers"], c["d_model"], c["n_heads"],
            c["n_kv_heads"], c["head_dim"], c["n_experts"], c["top_k"],
            c["moe_d_ff"])
        self.work = counts.pass_work(projs, n)
        self._eval = bank_eval

    def batch(self, i: int) -> dict:
        toks = self.pool[int(self.order[i % len(self.order)])]
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def run_pass(self, i: int, traced: bool = False):
        batch, params, cfg = self.batch(i), self.params, self.cfg
        fwd = self.fns.forward_train
        wrap, scope = pass_scope(traced)
        with scope:
            out = self._eval(
                lambda p: {"loss": fwd(params, batch, cfg, wrap(p))},
                self.bank, mode=self.spec["mode"],
                variant=self.spec["variant"])
        return out["loss"]

    def warmup(self):
        self.run_pass(0)

    def free_program(self):
        self.bank = None

    def reference(self, i: int, lower: bool = False) -> torch.Tensor:
        """The reference's loss of pass ``i`` under each lane.
        ``lower``: the control, one precision down: the float32 matmuls
        in TF32 and the datapath's float32 operands and results in
        bfloat16."""
        batch = self.batch(i)
        cfg = dict(self.mcfg, aux_loss_coef=self.aux_coef)
        cast = torch.bfloat16 if lower else torch.float32
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = lower
        out = []
        try:
            for lane in range(len(self.names)):
                table = torch.from_numpy(self.luts[lane]).to(self.device)
                with torch.inference_mode():
                    out.append(ref.loss(self.params, batch["tokens"],
                                        batch["targets"], cfg, table,
                                        act=self.cfg.dtype, cast=cast))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return torch.stack(out)

    def numbers_of(self, got, i: int) -> dict:
        """``loss_gap``: the widest gap between ``got`` (pass ``i``'s loss,
        every lane) and the reference's."""
        gap = (got.to(torch.float32) - self.reference(i)).abs().amax()
        return {"loss_gap": float(gap) if torch.isfinite(gap)
                else float("inf")}

    def control(self, i: int) -> dict:
        """The compared numbers of the control put in the program's
        place on pass ``i``."""
        return self.numbers_of(self.reference(i, lower=True), i)


def build(spec, config, seed, device, root):
    return LmBank(spec, config, seed, device, root)
