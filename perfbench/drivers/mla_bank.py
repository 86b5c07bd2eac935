"""Banked loss sweeps of a DeepSeek-V2 decoder on one chip's share of its
experts: one pass evaluates the training loss of one token batch under
every candidate multiplier of the bank, as ``lm_bank`` does for a GQA
MoE decoder.

The model: latent attention (MLA) in every layer, ``first_k_dense_
replace`` leading layers with a dense SwiGLU, then DeepSeekMoE layers
(shared experts, routed experts under group-limited routing, weights
times ``routed_scaling_factor``), YaRN RoPE.  The configuration file
gives the published sizes; its ``n_routed_experts`` is the experts this
chip holds, from ``port.expert_first``, and ``published`` the router's
full width.

Parameters (the workload file) are ``lm_bank``'s: ``lanes``, ``batch``
sequences of ``seq_len`` tokens a pass from ``pool_batches`` batches of
uniform ids in a seeded order, ``mode``, ``variant`` (every MLA,
dense-FFN, shared-expert and routed-expert projection banked),
``check_passes``, ``trace_passes`` and ``limits``.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from perfbench import counts, layer_counts, tables
from perfbench.harness import import_file
from perfbench.reference import decoder_mla as ref

lm_bank = import_file(Path(__file__).resolve().with_name("lm_bank.py"))


def model_config(config: dict) -> dict:
    """The model's sizes and routing, under the names the reference
    takes."""
    port, yarn = config["port"], config["rope_scaling"]
    if yarn.get("type") != "yarn":
        raise ValueError(f"mla_bank runs YaRN RoPE, not {yarn!r}")
    n_experts = config["published"].get("n_routed_experts",
                                        config["n_routed_experts"])
    return {
        "name": config["name"],
        "n_layers": config["num_hidden_layers"],
        "first_dense": config["first_k_dense_replace"],
        "d_model": config["hidden_size"],
        "n_heads": config["num_attention_heads"],
        "q_lora": config["q_lora_rank"], "kv_lora": config["kv_lora_rank"],
        "nope_dim": config["qk_nope_head_dim"],
        "rope_dim": config["qk_rope_head_dim"],
        "v_dim": config["v_head_dim"],
        "dense_d_ff": config["intermediate_size"],
        "expert_d_ff": config["moe_intermediate_size"],
        "n_shared": config["n_shared_experts"],
        "n_experts": n_experts, "top_k": config["num_experts_per_tok"],
        "held_first": port["expert_first"],
        "held": config["n_routed_experts"],
        "n_group": config["n_group"], "topk_group": config["topk_group"],
        "norm_topk_prob": config["norm_topk_prob"],
        "routed_scaling": float(config["routed_scaling_factor"]),
        "vocab": config["vocab_size"], "rope_theta": config["rope_theta"],
        "norm_eps": config["rms_norm_eps"],
        "capacity_factor": port["capacity_factor"],
        "aux_loss_coef": port["aux_loss_coef"],
        "yarn": {"factor": float(yarn["factor"]),
                 "original_max": yarn["original_max_position_embeddings"],
                 "beta_fast": float(yarn["beta_fast"]),
                 "beta_slow": float(yarn["beta_slow"]),
                 "mscale": float(yarn["mscale"]),
                 "mscale_all_dim": float(yarn["mscale_all_dim"])},
    }


def lm_config(c: dict, dtype):
    """The program's ``LMConfig`` of ``c`` (``model_config``)."""
    from repro_torch.models.common import LMConfig, YarnRope
    y = c["yarn"]
    return LMConfig(
        name=c["name"], family="moe", n_layers=c["n_layers"],
        d_model=c["d_model"], n_heads=c["n_heads"], n_kv_heads=c["n_heads"],
        d_ff=c["expert_d_ff"], vocab=c["vocab"], head_dim=c["nope_dim"],
        act="silu", rope_theta=c["rope_theta"], norm_eps=c["norm_eps"],
        n_experts=c["n_experts"], n_shared_experts=c["n_shared"],
        top_k=c["top_k"], moe_d_ff=c["expert_d_ff"],
        capacity_factor=c["capacity_factor"], use_mla=True,
        kv_lora=c["kv_lora"], q_lora=c["q_lora"],
        rope_head_dim=c["rope_dim"], v_head_dim=c["v_dim"], dtype=dtype,
        expert_first=c["held_first"], experts_held=c["held"],
        n_group=c["n_group"], topk_group=c["topk_group"],
        norm_topk_prob=c["norm_topk_prob"],
        routed_scaling=c["routed_scaling"], first_dense=c["first_dense"],
        first_dense_d_ff=c["dense_d_ff"],
        rope_scaling=YarnRope(y["factor"], y["original_max"],
                              y["beta_fast"], y["beta_slow"], y["mscale"],
                              y["mscale_all_dim"]))


def decoder_shapes(c: dict) -> dict:
    """The parameter tree's shapes in the program's layout
    (``models.decoder.init_params``): the leading dense layers in
    ``dense_blocks``, the MoE layers stacked in ``blocks``, each a
    latent attention and an FFN."""
    d, h = c["d_model"], c["n_heads"]

    def mla(g):
        return {"wdq": (g, d, c["q_lora"]),
                "wuq": (g, c["q_lora"], h * c["nope_dim"]),
                "wqr": (g, c["q_lora"], h * c["rope_dim"]),
                "wdkv": (g, d, c["kv_lora"]),
                "wuk": (g, c["kv_lora"], h * c["nope_dim"]),
                "wuv": (g, c["kv_lora"], h * c["v_dim"]),
                "wkr": (g, d, c["rope_dim"]),
                "wo": (g, h * c["v_dim"], d),
                "qn": (g, c["q_lora"]), "kvn": (g, c["kv_lora"])}

    def swiglu(lead, f):
        return {"wi": (*lead, d, f), "wo": (*lead, f, d),
                "wg": (*lead, d, f)}

    def block(g, ffn):
        return {"mixer_0": mla(g), "norm1_0": (g, d), "ffn_0": ffn,
                "norm2_0": (g, d)}

    g, e, f = c["n_layers"] - c["first_dense"], c["held"], c["expert_d_ff"]
    moe = {"router": (g, d, c["n_experts"]), **swiglu((g, e), f),
           "shared": swiglu((g,), f * c["n_shared"])}
    shapes = {"embed": (c["vocab"], d), "final_norm": (d,),
              "unembed": (c["vocab"], d), "blocks": block(g, moe)}
    if c["first_dense"]:
        shapes["dense_blocks"] = block(
            c["first_dense"], swiglu((c["first_dense"],), c["dense_d_ff"]))
    return shapes


class MlaBank(lm_bank.LmBank):
    def __init__(self, spec, config, seed, device, root):
        from repro_torch.approx.layers import bank_eval
        from repro_torch.approx.specs import LutBank
        from repro_torch.models.registry import model_fns

        self.spec, self.device = spec, device
        self.mcfg = c = model_config(config)
        self.cfg = lm_config(c, getattr(torch, config["port"]["dtype"]))
        self.fns = model_fns(self.cfg)
        t0 = time.perf_counter()
        self.params = lm_bank.draw_weights(decoder_shapes(c), seed, device)
        for blocks in (self.params["blocks"],
                       self.params.get("dense_blocks")):
            for gain in ("qn", "kvn"):       # MLA's two norms' gains
                if blocks is not None:
                    blocks["mixer_0"][gain].fill_(1.0)
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
        projs = layer_counts.mla_moe_projections(
            b * s, c["n_layers"], c["first_dense"], c["d_model"],
            c["n_heads"], c["q_lora"], c["kv_lora"], c["nope_dim"],
            c["rope_dim"], c["v_dim"], c["dense_d_ff"], c["expert_d_ff"],
            c["expert_d_ff"] * c["n_shared"], c["top_k"], c["n_experts"],
            c["held"])
        self.work = counts.pass_work(projs, n)
        self._eval = bank_eval

    def reference(self, i: int, lower: bool = False) -> torch.Tensor:
        """The reference's loss of pass ``i`` under each lane.
        ``lower``: the control, one precision down: the float32 matmuls
        in TF32 and the datapath's float32 operands and results in
        bfloat16."""
        batch = self.batch(i)
        cast = torch.bfloat16 if lower else torch.float32
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = lower
        out = []
        try:
            for lane in range(len(self.names)):
                table = torch.from_numpy(self.luts[lane]).to(self.device)
                with torch.inference_mode():
                    out.append(ref.loss(self.params, batch["tokens"],
                                        batch["targets"], self.mcfg, table,
                                        act=self.cfg.dtype, cast=cast))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return torch.stack(out)


def build(spec, config, seed, device, root):
    return MlaBank(spec, config, seed, device, root)
