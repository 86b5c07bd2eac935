"""Module-axis approximation (port of ``repro.approx.modules``): a
stable taxonomy over every matmul call site in the models (DESIGN.md
§2.12).

The paper's resilience analysis assigns approximate multipliers per
*layer*; across a 2026 model zoo the natural unit is the *module
family* — "all attention query projections", "all MoE expert FFNs",
"all SSM input projections" — regardless of which block, prefix, or
architecture a call site lives in.  This module provides:

  * ``MODULE_FAMILIES`` + ``module_of(tag)`` — the taxonomy and the
    classifier mapping every layer tag the models emit (``attn.wq``,
    ``moe.shared.wi``, ``mamba.in_proj``, ``s0_b1_conv2``, ...) onto a
    stable family key;
  * ``ModuleMap`` — the per-model binding: which tags exist, which
    family each belongs to, and how many MACs each runs
    (``approx.workload.layer_mult_counts``), with ``lower()``
    translating module-keyed assignments into the per-layer-tag
    assignments the ``PolicyBank`` machinery understands;
  * ``module_policy_bank`` — packs module-keyed assignments into ONE
    ``PolicyBank`` (disjoint family coverage padded with an exact-LUT
    ``fill``), so a mixed-module sweep is one banked pass of the model
    via ``policy_bank_eval`` (one banked datapath call a call site and
    batch, K2 under ``pallas``, K4 under ``fused``), bit-identical to
    the per-layer lowering by construction.

Two taxonomy keys never classify a call site: ``moe.router`` and
``ssm.scan``.  The router einsum and the SSM state scan are exact by
design (the models keep norms/routing/attention-score einsums in f32 —
the paper's scope is multipliers inside projection/conv MACs), so
they are listed for completeness and rejected at lowering time.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

MODULE_FAMILIES = (
    "attention.q", "attention.k", "attention.v", "attention.o",
    "mlp.up", "mlp.gate", "mlp.down",
    "moe.router", "moe.expert",
    "ssm.scan", "ssm.in_proj", "ssm.out_proj",
    "cross_attention", "conv", "embed", "head",
)

#: Families that name exact (non-approximable) computations: no model
#: emits a matmul call site for them, and ``ModuleMap.lower`` rejects
#: assignments touching them.
EXACT_FAMILIES = ("moe.router", "ssm.scan")

_RESNET_CONV = re.compile(r"^s\d+_b\d+_(conv\d+|proj)$")

_ATTN_LEAF = {"wq": "attention.q", "wk": "attention.k",
              "wv": "attention.v", "wo": "attention.o"}
_MLA_LEAF = {"wdq": "attention.q", "wuq": "attention.q",
             "wqr": "attention.q",
             "wdkv": "attention.k", "wuk": "attention.k",
             "wkr": "attention.k",
             "wuv": "attention.v", "wo": "attention.o"}
_FFN_LEAF = {"wi": "mlp.up", "wg": "mlp.gate", "wo": "mlp.down"}


def module_of(tag: str) -> str:
    """Classify a layer tag into its module family.

    Covers every call-site name the shipped models emit (guarded by a
    counts-vs-``probe_layer_tags`` identity test per architecture);
    unknown tags raise so taxonomy drift fails loudly instead of
    silently landing in the wrong power bucket."""
    if tag == "head":
        return "head"
    if tag == "img_proj":
        return "embed"            # modality projection into the embedding
    if tag == "conv_init" or _RESNET_CONV.match(tag):
        return "conv"
    owner, _, leaf = tag.rpartition(".")
    base = owner.rsplit(".", 1)[-1]   # "enc.attn" -> "attn"
    if base == "xattn":
        return "cross_attention"
    if base == "mamba" and leaf in ("in_proj", "out_proj"):
        return f"ssm.{leaf}"
    if base == "attn" and leaf in _ATTN_LEAF:
        return _ATTN_LEAF[leaf]
    if base == "mla" and leaf in _MLA_LEAF:
        return _MLA_LEAF[leaf]
    if base == "moe" and leaf in _FFN_LEAF:
        return "moe.expert"       # routed expert weights, all projections
    if base in ("ffn", "shared") and leaf in _FFN_LEAF:
        return _FFN_LEAF[leaf]    # dense FFN / DeepSeek shared experts
    raise ValueError(f"unknown layer tag {tag!r}: not covered by the "
                     "module taxonomy (see repro_torch.approx.modules)")


@dataclass(frozen=True)
class ModuleMap:
    """A model's layer tags bound to the module taxonomy.

    ``layers`` fixes the per-layer axis order (the ``PolicyBank.layers``
    every lowered assignment shares); ``layer_module[tag]`` is the
    family; ``layer_counts[tag]`` the MAC count feeding the power /
    area / delay cost axes unchanged."""

    layers: tuple[str, ...]
    layer_module: Mapping[str, str]
    layer_counts: Mapping[str, int]

    @property
    def modules(self) -> tuple[str, ...]:
        """Families present in this model, in first-layer order."""
        return tuple(dict.fromkeys(self.layer_module[l]
                                   for l in self.layers))

    def module_layers(self, family: str) -> tuple[str, ...]:
        return tuple(l for l in self.layers
                     if self.layer_module[l] == family)

    def module_counts(self) -> dict[str, int]:
        """Per-family MAC counts (the module-axis analogue of
        ``layer_counts`` — what the composition stage weighs by)."""
        out: dict[str, int] = {}
        for l in self.layers:
            f = self.layer_module[l]
            out[f] = out.get(f, 0) + int(self.layer_counts[l])
        return out

    def module_shares(self) -> dict[str, float]:
        total = sum(self.layer_counts[l] for l in self.layers)
        return {f: c / total for f, c in self.module_counts().items()}

    def lower(self, module_assignment: Mapping[str, str]
              ) -> dict[str, str]:
        """Module-keyed assignment -> per-layer-tag assignment.

        Keys must be families present in this model; ``EXACT_FAMILIES``
        and absent families raise (an assignment that silently binds
        zero call sites would report golden quality at golden power and
        poison a Pareto front)."""
        present = set(self.modules)
        lowered: dict[str, str] = {}
        for family, mult in module_assignment.items():
            if family in EXACT_FAMILIES:
                raise ValueError(
                    f"module family {family!r} is exact by design "
                    "(no approximate matmul call sites)")
            if family not in present:
                raise ValueError(
                    f"module family {family!r} has no call sites in "
                    f"this model (present: {sorted(present)})")
            for l in self.module_layers(family):
                lowered[l] = mult
        return lowered

    def lower_many(self, assignments: Sequence[Mapping[str, str]]
                   ) -> list[dict[str, str]]:
        return [self.lower(a) for a in assignments]

    @staticmethod
    def from_layer_counts(layer_counts: Mapping[str, int]) -> "ModuleMap":
        layers = tuple(layer_counts)
        return ModuleMap(
            layers=layers,
            layer_module={l: module_of(l) for l in layers},
            layer_counts={l: int(layer_counts[l]) for l in layers})

    @staticmethod
    def for_config(cfg, batch: int = 1, seq_len: int = 16,
                   validate: bool = True) -> "ModuleMap":
        """Build the map for a ``ResNetConfig`` or a ported ``LMConfig``
        from the unified MAC accounting.  ``validate=True`` (LM
        configs) runs one prefill on the ``meta`` device
        (``probe_layer_tags``: shapes only, no FLOPs, no parameter
        memory) and asserts the counted tags are exactly the call sites
        the model hits — the drift guard between the analytic counts
        and the real forward."""
        from .workload import layer_mult_counts
        counts = layer_mult_counts(cfg, batch=batch, seq_len=seq_len)
        if validate and not hasattr(cfg, "widths"):
            from ..models.registry import abstract_params, probe_layer_tags
            tags = set(probe_layer_tags(cfg, abstract_params(cfg)))
            if tags != set(counts):
                raise AssertionError(
                    f"MAC accounting drift for {cfg.name}: counted "
                    f"{sorted(set(counts) - tags)} not hit by the "
                    f"forward; hit {sorted(tags - set(counts))} not "
                    "counted")
        return ModuleMap.from_layer_counts(counts)


#: The exact 8-bit LUT row: bit-identical to the golden int8 datapath
#: (it tabulates the same products), so padding a partial lowered row
#: with it keeps the lane equal to the sequential golden-base policy.
FILL_EXACT = "mul8u_exact"


def module_policy_bank(mmap: ModuleMap,
                       module_assignments: Sequence[Mapping[str, str]],
                       library=None, fill: str = FILL_EXACT,
                       block_m: int = 512):
    """Pack module-keyed assignments into ONE ``PolicyBank`` over the
    full per-layer axis (rows padded with ``fill`` where a family
    leaves tags unassigned).  Returns ``(pbank, lowered)`` where
    ``lowered[i]`` is the per-layer dict row ``i`` stands for —
    evaluate with ``approx.layers.policy_bank_eval`` for the one banked
    pass, or ``policy_for_lane`` sequentially."""
    from .specs import PolicyBank
    lowered = mmap.lower_many(module_assignments)
    pbank = PolicyBank.from_assignments(
        lowered, library, layers=mmap.layers, block_m=block_m, fill=fill)
    return pbank, lowered


def module_sweep_assignments(mmap: ModuleMap,
                             multipliers: Sequence[str],
                             families: Optional[Sequence[str]] = None
                             ) -> list[tuple[str, str, dict[str, str]]]:
    """The single-family sweep grid: ``(family, multiplier,
    {family: multiplier})`` for every present family x multiplier —
    the module-axis analogue of the paper's Fig. 4 per-layer sweep."""
    fams = tuple(families) if families is not None else mmap.modules
    return [(f, m, {f: m}) for f in fams for m in multipliers]
