"""Shared set-up of the port's training parity tests: one reduced arch
in both packages with the reference's parameters carried across, and a
token batch (numpy, ``data.synthetic.token_stream``) with the family's
non-token inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.data.synthetic import token_stream
from repro.models.registry import model_fns as ref_model_fns
from repro_torch.configs import get_config
from repro_torch.models.registry import input_extras, model_fns
from repro_torch.models.weights import lm_params_from_numpy

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def setup(arch: str, dtype=jnp.float32, batch: int = 2, seq: int = 12,
          **overrides):
    """(ref cfg, port cfg, ref fns, port fns, ref params, port params,
    numpy batch) for ``arch`` reduced."""
    rc = ref_get_config(arch).reduced(dtype=dtype, **overrides)
    pc = get_config(arch).reduced(dtype=TORCH_DTYPE[dtype], **overrides)
    rp = ref_model_fns(rc).init_params(jax.random.PRNGKey(0), rc)
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, rp))
    tokens, targets = token_stream(rc.vocab, batch, seq, 0)
    b = {"tokens": tokens, "targets": targets, **input_extras(pc, batch)}
    return rc, pc, ref_model_fns(rc), model_fns(pc), rp, pp, b


def ref_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def port_batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def requires_grad(tree):
    if isinstance(tree, dict):
        return {k: requires_grad(v) for k, v in tree.items()}
    return tree.requires_grad_(True)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
