"""Workload layer: model + eval data + NAMED quality metrics (port of
``repro.approx.workload``, DESIGN.md §2.7).

A ``Workload`` bundles what the DSE needs to measure application-level
quality under an ``ApproxPolicy``, in both calling conventions the
sweeps understand:

  * ``fn(policy) -> {metric: float}`` — the sequential closure, and
  * ``traceable_metrics(policy) -> {metric: tensor}`` — its tensor
    core, which the batched engine (``approx.layers.bank_eval``) calls
    once with a banked policy; each metric then carries a leading lane
    axis.

Shipped adapters: ``classification(cfg, model)`` — ResNet /
synthetic-CIFAR top-1 accuracy, the paper's case study (with
``fidelity=True`` also the logit MAE against the golden int8 logits);
``logit_fidelity(forward, inputs)`` — mean |logit error| against a
reference datapath, the wide-width study's fidelity axis; and
``lm_fidelity(cfg)`` — the same metrics for any LM config of the zoo
(dense, moe, ssm, hybrid, MLA, vlm with its image embeddings, encdec
with its audio frames); ``lm_perplexity(cfg)`` — the LM loss and its
perplexity through ``forward_train``.  ``layer_mult_counts`` is the one
MAC accounting for ResNets and those LM families.

A lane-split evaluation (``bank_eval(sharding=...)``) runs the tensor
core on every device of its mesh, and a shard must never read a tensor
of another device.  The adapters' tensor cores are therefore
``DeviceForms``: ``traceable_metrics.on_device(d)`` is the same closure
over copies of the model, the eval data and the reference logits on
``d``, made once a device and kept (the choice of a per-device form over
moving inputs in the banked call: the closures own their tensors).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Mapping, Optional, Union

import numpy as np
import torch

from ..device import DeviceLike, device_key, replicate, resolve_device
from .layers import (EXACT_POLICY, ApproxPolicy, conv_mult_count,
                     dense_mult_count, per_lane)
from .objectives import ensure_objective

MetricFn = Callable[[ApproxPolicy], Mapping[str, Any]]


class DeviceForms:
    """A tensor closure with one form a device.  ``make(state, device)``
    builds the closure over ``state`` (tensors, modules, trees of them)
    living on ``device``; calling this object calls the form on its home
    ``device``, and ``on_device(d)`` returns the form over a copy of
    ``state`` on ``d`` (``device.replicate``), made once and kept."""

    def __init__(self, make, state, device: DeviceLike):
        self.device = device_key(device)
        self._make, self._state = make, state
        self._forms = {self.device: make(state, self.device)}

    def __call__(self, policy):
        return self._forms[self.device](policy)

    def on_device(self, device: DeviceLike):
        dev = device_key(device)
        form = self._forms.get(dev)
        if form is None:
            form = self._forms[dev] = self._make(
                replicate(self._state, dev), dev)
        return form


@dataclass
class Workload:
    """A named evaluation scenario: policy in, metric dict out.

    ``metrics`` fixes the metric names (and their order in sweep rows);
    ``directions`` maps each to "max"/"min" (default "max") and is
    registered into the objectives registry at construction.
    ``layer_counts`` optionally carries the model's per-layer
    multiplication counts.  ``traceable_metrics`` may be ``None`` — the
    workload then runs on the sequential sweep paths only."""

    name: str
    fn: MetricFn
    metrics: tuple[str, ...]
    primary: Optional[str] = None
    traceable_metrics: Optional[MetricFn] = None
    directions: Mapping[str, str] = field(default_factory=dict)
    layer_counts: Optional[dict[str, int]] = None

    def __post_init__(self):
        if not self.metrics:
            raise ValueError("a Workload needs at least one metric")
        if self.primary is None:
            self.primary = self.metrics[0]
        if self.primary not in self.metrics:
            raise ValueError(f"primary {self.primary!r} not among "
                             f"metrics {self.metrics}")
        for m in self.metrics:
            ensure_objective(m, self.directions.get(m, "max"),
                             source="workload")

    # -- calling conventions -------------------------------------------
    def measure(self, policy: ApproxPolicy) -> dict[str, float]:
        """Sequential evaluation: every metric as a Python float, in
        ``metrics`` order."""
        out = self.fn(policy)
        return {m: float(out[m]) for m in self.metrics}

    def __call__(self, policy: ApproxPolicy) -> float:
        """Legacy scalar convention: the primary metric's value."""
        return float(self.fn(policy)[self.primary])

    @property
    def primary_direction(self) -> str:
        return self.directions.get(self.primary, "max")

    @property
    def traceable(self):
        """Scalar-primary projection of the tensor core (None when the
        workload has none)."""
        if self.traceable_metrics is None:
            return None
        tm, primary = self.traceable_metrics, self.primary
        return lambda policy: tm(policy)[primary]

    def cached(self, cache: dict) -> "Workload":
        """The same workload through a policy-keyed metric-dict cache
        (the ``explore()`` resume/widen mechanism)."""
        def fn(policy: ApproxPolicy) -> dict[str, float]:
            key = policy.cache_key()
            if key not in cache:
                cache[key] = self.measure(policy)
            return cache[key]
        return replace(self, fn=fn)


def as_workload(eval_fn) -> Workload:
    """Normalize any sweep evaluation handle into a ``Workload``: a
    ``Workload`` passes through; anything with ``fn`` + ``traceable``
    (a ``BankableEval``) becomes a single-metric ``accuracy`` workload
    keeping its tensor core; a plain callable becomes a sequential-only
    ``accuracy`` workload."""
    if isinstance(eval_fn, Workload):
        return eval_fn
    traceable = getattr(eval_fn, "traceable", None)
    seq = getattr(eval_fn, "fn", eval_fn)
    if not callable(seq):
        raise TypeError(f"not an evaluation function: {eval_fn!r}")
    return Workload(
        name=getattr(eval_fn, "name", None)
        or getattr(eval_fn, "__name__", type(eval_fn).__name__),
        fn=lambda policy: {"accuracy": seq(policy)},
        metrics=("accuracy",),
        traceable_metrics=(None if traceable is None else
                           (lambda policy: {"accuracy": traceable(policy)})),
        directions={"accuracy": "max"})


# ----------------------------------------------------------------------
# Shipped adapter
# ----------------------------------------------------------------------
def classification(cfg, model, *, eval_n: int = 256, batch: int = 64,
                   name: Optional[str] = None,
                   fidelity: bool = False,
                   device: DeviceLike = None) -> Workload:
    """ResNet / synthetic-CIFAR top-1 accuracy — the paper's case-study
    quality metric, as a bankable workload.  ``model`` (a
    ``repro_torch.models.resnet.ResNet``) is moved to ``device`` (the
    GPU unless ``device="cpu"``).  Evaluation runs batch by batch, as in
    the reference: BN statistics are per ``batch`` images, and the
    accuracy is the mean of the per-batch accuracies.

    ``fidelity=True`` adds ``logit_mae`` (minimize, PRIMARY) against the
    golden-int8 logits, computed once here: the mean over batches of the
    per-batch mean |logits − golden|, the continuous quality axis the
    surrogate predict stage trains and gates on (DESIGN.md §2.11).
    Accuracy stays measured either way.  Under a banked policy every
    float mean runs lane by lane (``per_lane``), so a banked lane equals
    its sequential evaluation bit for bit."""
    from ..data.synthetic import CifarBatches
    from ..models import resnet
    from .specs import BackendSpec

    dev = resolve_device(device)
    model = model.to(dev)
    eval_batches = list(CifarBatches("test", eval_n, batch).eval_batches())
    images = torch.from_numpy(
        np.stack([b["images"] for b in eval_batches])).to(dev)
    labels = torch.from_numpy(
        np.stack([b["labels"] for b in eval_batches])).to(dev)

    ref = None
    if fidelity:
        golden = ApproxPolicy(default=BackendSpec.golden().materialize())
        with torch.inference_mode():
            ref = [resnet.forward(model, images[i], cfg, golden)
                   for i in range(images.shape[0])]

    def make(state, _dev):
        model, images, labels, ref = state

        def traceable_metrics(policy):
            logits = [resnet.forward(model, images[i], cfg, policy)
                      for i in range(images.shape[0])]
            accs = [torch.mean((torch.argmax(l, dim=-1) == labels[i])
                               .to(torch.float32), dim=-1)
                    for i, l in enumerate(logits)]
            out = {"accuracy": torch.mean(torch.stack(accs), dim=0)}
            if ref is not None:
                lanes = logits[0].ndim == ref[0].ndim + 1
                maes = [per_lane(lambda t, r=r: torch.mean(
                    torch.abs(t - r)), l, lanes)
                    for l, r in zip(logits, ref)]
                out["logit_mae"] = per_lane(
                    torch.mean, torch.stack(maes, -1), lanes)
            return out
        return traceable_metrics

    traceable_metrics = DeviceForms(make, (model, images, labels, ref), dev)

    def fn(policy):
        with torch.inference_mode():
            out = traceable_metrics(policy)
        return {k: float(v) for k, v in out.items()}

    directions = {"logit_mae": "min"} if fidelity else {}
    directions["accuracy"] = "max"
    return Workload(
        name=name or (f"classification[resnet{getattr(cfg, 'depth', '')}]"
                      + ("+fidelity" if fidelity else "")),
        fn=fn, metrics=tuple(directions),
        traceable_metrics=traceable_metrics, directions=directions,
        layer_counts=resnet.layer_mult_counts(cfg))


def logit_fidelity(forward, inputs, *,
                   ref_policy: ApproxPolicy = EXACT_POLICY,
                   name: str = "logit_fidelity",
                   layer_counts: Optional[dict[str, int]] = None,
                   forward_on: Optional[Callable] = None) -> Workload:
    """Logit fidelity vs a reference datapath (default: exact f32).

    ``forward(policy, x) -> logits`` is the model closure; ``inputs``
    the eval batches.  Metrics:

      * ``logit_mae`` (minimize) — mean over batches of the per-batch
        mean |logits − reference|, the continuous axis where datapath
        width shows while top-1 accuracy saturates (DESIGN.md §2.6);
      * ``top1_agreement`` (maximize) — fraction of argmax decisions
        matching the reference.

    The reference logits are computed once, at construction.  Under a
    banked policy the logits carry a lane axis; every mean then runs
    lane by lane (``per_lane``), so a banked lane equals its sequential
    evaluation bit for bit.

    ``forward_on(d)``, when given, is ``forward``'s form on device ``d``
    (made once a device): the tensor core then has a per-device form
    (``DeviceForms``, home: the reference logits' device)."""
    inputs = list(inputs)
    with torch.inference_mode():
        ref = [forward(ref_policy, x) for x in inputs]

    def make(state, dev):
        inputs, ref = state
        fwd = (forward if forward_on is None or dev == home
               else forward_on(dev))

        def traceable_metrics(policy):
            maes, agree = [], []
            for x, r in zip(inputs, ref):
                logits = fwd(policy, x)
                lanes = logits.ndim == r.ndim + 1
                maes.append(per_lane(lambda t: torch.mean(
                    torch.abs(t - r)), logits, lanes))
                agree.append(per_lane(lambda t: torch.mean(
                    (torch.argmax(t, -1) == torch.argmax(r, -1))
                    .to(torch.float32)), logits, lanes))
            lanes = maes[0].ndim == 1
            return {"logit_mae": per_lane(torch.mean,
                                          torch.stack(maes, -1), lanes),
                    "top1_agreement": per_lane(
                        torch.mean, torch.stack(agree, -1), lanes)}
        return traceable_metrics

    home = device_key(ref[0].device)
    traceable_metrics = DeviceForms(make, (inputs, ref), home)

    def fn(policy):
        with torch.inference_mode():
            out = traceable_metrics(policy)
        return {k: float(v) for k, v in out.items()}

    return Workload(name=name, fn=fn,
                    metrics=("logit_mae", "top1_agreement"),
                    primary="logit_mae",
                    traceable_metrics=traceable_metrics,
                    directions={"logit_mae": "min",
                                "top1_agreement": "max"},
                    layer_counts=layer_counts)


# ----------------------------------------------------------------------
# MAC accounting (the Workload.layer_counts protocol; DESIGN.md §2.12)
# ----------------------------------------------------------------------
def _resnet_mult_counts(cfg, batch: int) -> dict[str, int]:
    counts: dict[str, int] = {}
    size = cfg.image_size
    counts["conv_init"] = conv_mult_count((batch, size, size, 3),
                                          (3, 3, 3, cfg.widths[0]))
    cin = cfg.widths[0]
    for s, width in enumerate(cfg.widths):
        for b in range(cfg.n_blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            out_size = size // stride
            counts[f"s{s}_b{b}_conv1"] = conv_mult_count(
                (batch, size, size, cin), (3, 3, cin, width), stride)
            counts[f"s{s}_b{b}_conv2"] = conv_mult_count(
                (batch, out_size, out_size, width), (3, 3, width, width))
            if cin != width:
                counts[f"s{s}_b{b}_proj"] = conv_mult_count(
                    (batch, size, size, cin), (1, 1, cin, width), stride)
            size = out_size
            cin = width
    counts["head"] = dense_mult_count((batch, cfg.widths[-1]),
                                      (cfg.widths[-1], cfg.n_classes))
    return counts


def _merge_counts(dst: dict, src: Mapping[str, int], scale: int = 1):
    for tag, c in src.items():
        dst[tag] = dst.get(tag, 0) + int(c) * scale


def _attn_counts(cfg, t: int, prefix: str = "attn") -> dict[str, int]:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        f"{prefix}.wq": dense_mult_count((t, d), (d, h * hd)),
        f"{prefix}.wk": dense_mult_count((t, d), (d, hk * hd)),
        f"{prefix}.wv": dense_mult_count((t, d), (d, hk * hd)),
        f"{prefix}.wo": dense_mult_count((t, h * hd), (h * hd, d)),
    }


def _mla_counts(cfg, t: int) -> dict[str, int]:
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    ql, kl = cfg.q_lora, cfg.kv_lora
    return {
        "mla.wdq": dense_mult_count((t, d), (d, ql)),
        "mla.wuq": dense_mult_count((t, ql), (ql, h * dn)),
        "mla.wqr": dense_mult_count((t, ql), (ql, h * dr)),
        "mla.wdkv": dense_mult_count((t, d), (d, kl)),
        "mla.wuk": dense_mult_count((t, kl), (kl, h * dn)),
        "mla.wuv": dense_mult_count((t, kl), (kl, h * dv)),
        "mla.wkr": dense_mult_count((t, d), (d, dr)),
        "mla.wo": dense_mult_count((t, h * dv), (h * dv, d)),
    }


def _ffn_counts(cfg, t: int, prefix: str = "ffn",
                d_ff: Optional[int] = None) -> dict[str, int]:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    counts = {
        f"{prefix}.wi": dense_mult_count((t, d), (d, f)),
        f"{prefix}.wo": dense_mult_count((t, f), (f, d)),
    }
    if cfg.act == "silu":
        counts[f"{prefix}.wg"] = dense_mult_count((t, d), (d, f))
    return counts


def _moe_counts(cfg, t: int) -> dict[str, int]:
    """Expert MACs mirror the sort-based dispatch exactly: every expert
    processes its full capacity buffer (zero-padded slots multiply
    too), so the per-projection cost is ``nb * E * C * d * f`` with the
    same blocked/unblocked capacity arithmetic as ``models.moe``; a
    chip's share (``cfg.held_experts``) holds buffers for its experts
    alone, at the capacity of all ``n_experts``.  The router stays
    exact (f32) and carries no approximate MACs."""
    from ..models.moe import capacity
    e, k, d = len(cfg.held_experts), cfg.top_k, cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    nb = cfg.moe_blocks
    if nb > 1 and t % nb == 0 and t // nb >= k:
        tb = t // nb
    else:
        nb, tb = 1, t
    per = nb * e * capacity(cfg, tb)
    counts = {"moe.wi": per * d * f, "moe.wo": per * f * d}
    if cfg.act == "silu":
        counts["moe.wg"] = per * d * f
    if cfg.n_shared_experts > 0:
        counts.update(_ffn_counts(cfg, t, prefix="moe.shared",
                                  d_ff=f * cfg.n_shared_experts))
    return counts


def _mamba_counts(cfg, t: int) -> dict[str, int]:
    from ..models.mamba2 import ssm_dims
    dd = ssm_dims(cfg)
    d, di = cfg.d_model, dd["d_inner"]
    d_proj = 2 * di + 2 * dd["n"] + dd["n_heads"]
    return {
        "mamba.in_proj": dense_mult_count((t, d), (d, d_proj)),
        "mamba.out_proj": dense_mult_count((t, di), (di, d)),
    }


def _encdec_mult_counts(cfg, batch: int, seq_len: int) -> dict[str, int]:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    t_enc = batch * cfg.enc_frames
    t_dec = batch * seq_len
    counts: dict[str, int] = {}
    _merge_counts(counts, _attn_counts(cfg, t_enc, prefix="enc.attn"),
                  cfg.n_enc_layers)
    _merge_counts(counts, _ffn_counts(cfg, t_enc, prefix="enc.ffn"),
                  cfg.n_enc_layers)
    _merge_counts(counts, _attn_counts(cfg, t_dec, prefix="dec.attn"),
                  cfg.n_layers)
    _merge_counts(counts, _ffn_counts(cfg, t_dec, prefix="dec.ffn"),
                  cfg.n_layers)
    # cross-attention: queries/output over the decoder positions, the
    # cross-KV over the encoder frames, once a decoder layer
    _merge_counts(counts, {
        "xattn.wq": dense_mult_count((t_dec, d), (d, h * hd)),
        "xattn.wk": dense_mult_count((t_enc, d), (d, h * hd)),
        "xattn.wv": dense_mult_count((t_enc, d), (d, h * hd)),
        "xattn.wo": dense_mult_count((t_dec, h * hd), (h * hd, d)),
    }, cfg.n_layers)
    return counts


def layer_mult_counts(cfg, batch: int = 1,
                      seq_len: int = 16) -> dict[str, int]:
    """Per-layer-tag multiplication counts for a ``ResNetConfig``
    (``seq_len`` ignored) or any ``LMConfig`` family (dense / moe / ssm
    / hybrid / vlm / encdec) — the one MAC accounting behind the
    ``Workload.layer_counts`` protocol (DESIGN.md §2.12).  Layer tags
    are shared across the stacked blocks ("attn.wq", "moe.wi", ...), so
    each tag's count aggregates over every block that uses it, slot by
    slot of ``models.decoder.block_pattern``; non-token inputs count the
    way the adapters feed them (``registry.input_extras``): a vlm
    prepends ``n_img_tokens`` image positions (plus the ``img_proj``
    projection itself), an encdec runs its encoder over ``enc_frames``
    per batch element.  Exact einsums (norms, attention scores, the MoE
    router, the SSM scan) carry no approximate MACs and do not
    appear.  Leading dense layers (``cfg.first_dense``) count the
    pattern's mixer and an FFN of ``cfg.first_dense_d_ff``."""
    if hasattr(cfg, "widths"):          # ResNetConfig, without an import
        return _resnet_mult_counts(cfg, batch)
    if cfg.family == "encdec":
        return _encdec_mult_counts(cfg, batch, seq_len)
    from ..models.decoder import block_pattern

    # vlm image embeddings are prepended to the tokens, so every decoder
    # projection also runs over those positions
    extra = cfg.n_img_tokens if cfg.family == "vlm" else 0
    t = batch * (seq_len + extra)
    pattern = block_pattern(cfg)
    reps = (cfg.n_layers - cfg.first_dense) // len(pattern)
    per_group: dict[str, int] = {}
    mixers = {"attn": _attn_counts, "mla": _mla_counts,
              "mamba": _mamba_counts}
    lead: dict[str, int] = {}
    if cfg.first_dense:
        _merge_counts(lead, mixers[pattern[0][0]](cfg, t))
        _merge_counts(lead, _ffn_counts(cfg, t, d_ff=cfg.first_dense_d_ff))
    for mixer, ffn_kind in pattern:
        _merge_counts(per_group, mixers[mixer](cfg, t))
        if ffn_kind == "ffn":
            _merge_counts(per_group, _ffn_counts(cfg, t))
        elif ffn_kind == "moe":
            _merge_counts(per_group, _moe_counts(cfg, t))
    counts = {tag: c * reps for tag, c in per_group.items()}
    _merge_counts(counts, lead, cfg.first_dense)
    if cfg.family == "vlm" and cfg.n_img_tokens > 0:
        counts["img_proj"] = dense_mult_count(
            (batch * cfg.n_img_tokens, cfg.d_model),
            (cfg.d_model, cfg.d_model))
    return counts


def lm_layer_mult_counts(cfg, batch: int, seq_len: int) -> dict[str, int]:
    """The reference's earlier name for ``layer_mult_counts`` on LM
    configs."""
    return layer_mult_counts(cfg, batch=batch, seq_len=seq_len)


# ----------------------------------------------------------------------
# LM adapters
# ----------------------------------------------------------------------
def _lm_setup(cfg, params, seed: int, device: DeviceLike):
    """(cfg, params, model fns, device) for the LM adapters.  ``cfg`` may
    be an ``LMConfig`` or a ported arch name (resolved through
    ``configs.get_config(...).reduced()``, so adapters stay smoke-test
    sized by default).  Without ``params`` the weights are drawn on the
    device from a ``torch.Generator`` seeded ``seed`` (the reference
    uses ``PRNGKey(seed)``; the streams differ)."""
    from ..models.registry import model_fns

    if isinstance(cfg, str):
        from ..configs import get_config
        cfg = get_config(cfg).reduced()
    dev = resolve_device(device)
    fns = model_fns(cfg)
    if params is None:
        params = fns.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
    return cfg, params, fns, dev


def _lm_token_batches(cfg, batch: int, seq_len: int, n_batches: int,
                      seed: int, device: torch.device) -> list:
    """The reference's deterministic synthetic token batches (numpy,
    ``data.synthetic.token_stream``), on ``device``, with the family's
    non-token inputs (``registry.input_extras``)."""
    from ..data.synthetic import token_stream
    from ..models.registry import input_extras

    extras = {k: torch.from_numpy(v).to(device)
              for k, v in input_extras(cfg, batch).items()}
    out = []
    for i in range(n_batches):
        tokens, targets = token_stream(cfg.vocab, batch, seq_len,
                                       step=i, seed=seed)
        out.append({"tokens": torch.from_numpy(tokens).to(device),
                    "targets": torch.from_numpy(targets).to(device),
                    **extras})
    return out


def lm_fidelity(cfg: Union[str, Any], params=None, *, batch: int = 2,
                seq_len: int = 16, n_batches: int = 2, seed: int = 0,
                device: DeviceLike = None) -> Workload:
    """Decoder logit fidelity vs the f32 model: prefill the LM on the
    deterministic synthetic token batches and compare the last-position
    logits against the exact-datapath reference — ``logit_mae``
    (minimize, primary) + ``top1_agreement`` (maximize), for any LM
    config, with the family's non-token inputs (``input_extras``) and a
    cache of ``seq_len + prompt_extra_len`` rows.  Runs on ``device``
    (the GPU unless ``"cpu"``); ``params`` may be given, e.g. the reference's carried across with
    ``models.weights.lm_params_from_numpy``.  Under a banked policy the
    logits carry a bank lane axis and each lane equals its sequential
    evaluation bit for bit (``logit_fidelity``)."""
    from ..models.registry import prompt_extra_len

    cfg, params, fns, dev = _lm_setup(cfg, params, seed, device)
    batches = _lm_token_batches(cfg, batch, seq_len, n_batches, seed, dev)
    max_len = seq_len + prompt_extra_len(cfg, batches[0])

    def forward_on(d, params=params):
        def forward(policy, b):
            cache = fns.init_cache(cfg, batch, max_len, d)
            logits, _ = fns.forward_prefill(params, b, cache, cfg, policy)
            return logits
        return forward

    return logit_fidelity(
        forward_on(dev), batches, name=f"lm_fidelity[{cfg.name}]",
        layer_counts=layer_mult_counts(cfg, batch, seq_len),
        forward_on=lambda d: forward_on(d, replicate(params, d)))


def lm_perplexity(cfg: Union[str, Any], params=None, *, batch: int = 2,
                  seq_len: int = 16, n_batches: int = 2, seed: int = 0,
                  device: DeviceLike = None) -> Workload:
    """Decoder LM loss/perplexity on the deterministic synthetic token
    batches: ``perplexity`` (minimize, primary) = exp(mean CE loss),
    plus the raw ``loss``, through ``forward_train`` under
    ``torch.inference_mode()``.  An untrained tiny config still yields a
    meaningful *relative* axis — approximation error moves the loss.
    Under a banked policy each batch's loss is one value a lane, and the
    means run lane by lane (``per_lane``), so a banked lane equals its
    sequential evaluation bit for bit."""
    cfg, params, fns, dev = _lm_setup(cfg, params, seed, device)
    batches = _lm_token_batches(cfg, batch, seq_len, n_batches, seed, dev)

    def make(state, _dev):
        params, batches = state

        def traceable_metrics(policy):
            losses = torch.stack([fns.forward_train(params, b, cfg, policy)
                                  for b in batches], -1)
            loss = per_lane(torch.mean, losses, losses.ndim == 2)
            return {"perplexity": torch.exp(loss), "loss": loss}
        return traceable_metrics

    traceable_metrics = DeviceForms(make, (params, batches), dev)

    def fn(policy):
        with torch.inference_mode():
            out = traceable_metrics(policy)
        return {k: float(v) for k, v in out.items()}

    return Workload(name=f"lm_perplexity[{cfg.name}]", fn=fn,
                    metrics=("perplexity", "loss"), primary="perplexity",
                    traceable_metrics=traceable_metrics,
                    directions={"perplexity": "min", "loss": "min"},
                    layer_counts=layer_mult_counts(cfg, batch, seq_len))
