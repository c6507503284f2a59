"""Sparse-attention graph transformer — the flagship model family.

The reference is a kernel library, not a model framework; its README names
SDDMM's role in "graph attention networks and sparse transformers"
(reference README.md:6-10). This module is that consumer, built natively on
the framework's ops so the whole stack (reorder -> pack -> hybrid SDDMM ->
edge softmax -> SpMM aggregate) exercises end to end and scales over a mesh:

    scores  = SDDMM(Q, K^T, S)          # edge logits, only where S != 0
    alpha   = edge_softmax(scores)       # per-row normalization
    out     = SpMM(alpha, V)             # attention-weighted aggregation

Multi-head attention over a static graph mask, LayerNorm + MLP, pure
functional params (haiku/flax-free to keep the dependency surface small),
optax-compatible training step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.formats import CSR
from bsmr_sddmm_tpu.ops.graph_rphm import make_sparse_attention_rphm
from bsmr_sddmm_tpu.ops.sddmm import DevicePlan, device_plan, make_sddmm_body
from bsmr_sddmm_tpu.pack import TilePlan, pack_tiles
from bsmr_sddmm_tpu.reorder import bsmr


@dataclasses.dataclass(frozen=True)
class GraphTransformer:
    """Static model description bound to one graph mask."""

    num_nodes: int
    feature_dim: int
    head_dim: int
    num_heads: int = 4
    num_layers: int = 2
    num_classes: int = 8

    @property
    def model_dim(self) -> int:
        return self.head_dim * self.num_heads


def init_params(model: GraphTransformer, seed: int = 0) -> Dict:
    rng = np.random.default_rng(seed)
    d, h, hd = model.model_dim, model.num_heads, model.head_dim

    def dense(shape, scale=None):
        scale = scale or (1.0 / np.sqrt(shape[0]))
        return jnp.asarray(rng.normal(0, scale, shape), jnp.float32)

    params = {"embed": dense((model.feature_dim, d))}
    for L in range(model.num_layers):
        params[f"layer_{L}"] = {
            "wq": dense((d, d)), "wk": dense((d, d)), "wv": dense((d, d)),
            "wo": dense((d, d)),
            "ln1_scale": jnp.ones(d), "ln1_bias": jnp.zeros(d),
            "ln2_scale": jnp.ones(d), "ln2_bias": jnp.zeros(d),
            "mlp_in": dense((d, 4 * d)), "mlp_out": dense((4 * d, d)),
        }
    params["head"] = dense((d, model.num_classes))
    return params


def _layer_norm(x, scale, bias, eps=1e-6):
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * scale + bias


def make_forward(model: GraphTransformer, csr: CSR,
                 config: Optional[SddmmConfig] = None
                 ) -> Tuple[Callable, DevicePlan, TilePlan]:
    """Build ``forward(params, X, dplan) -> logits`` with the sparse
    attention bound to ``csr``'s packed TilePlan. Per-head SDDMM runs the
    same hybrid body, vmapped over heads."""
    config = config or SddmmConfig(k=model.head_dim)
    config = config.replace(k=model.head_dim)
    reord = bsmr(csr, config)
    plan = pack_tiles(csr, reord, config, k=model.head_dim)
    # tile-native attention: SDDMM -> edge softmax -> SpMM entirely in the
    # rphm layout (no per-element CSR round trip anywhere in the layer)
    body = make_sddmm_body(plan, config, emit="rphm")
    head_fn = make_sparse_attention_rphm(plan, body)
    n_nodes = csr.rows

    def attention(layer_params, x, dplan):
        d, h, hd = model.model_dim, model.num_heads, model.head_dim
        q = (x @ layer_params["wq"]).reshape(n_nodes, h, hd)
        kk = (x @ layer_params["wk"]).reshape(n_nodes, h, hd)
        v = (x @ layer_params["wv"]).reshape(n_nodes, h, hd)
        # static loop over heads: the per-head body is traced once per
        # head and shares one plan (a batched head axis is future work)
        heads = jnp.stack([head_fn(q[:, h_], kk[:, h_], v[:, h_], dplan)
                           for h_ in range(h)], axis=1)
        return heads.reshape(n_nodes, d) @ layer_params["wo"]

    def forward(params, X, dplan):
        x = X @ params["embed"]
        for L in range(model.num_layers):
            lp = params[f"layer_{L}"]
            x = x + attention(
                lp, _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]), dplan)
            hmid = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
            x = x + jax.nn.gelu(hmid @ lp["mlp_in"]) @ lp["mlp_out"]
        return x @ params["head"]

    return forward, device_plan(plan), plan


def make_train_step(model: GraphTransformer, forward: Callable,
                    learning_rate: float = 1e-3) -> Tuple[Callable, Callable]:
    """Optax-based training step: ``(opt_init, train_step)`` where
    ``train_step(params, opt_state, X, labels, dplan)`` returns
    ``(params, opt_state, loss)``."""
    import optax
    tx = optax.adam(learning_rate)

    def loss_fn(params, X, labels, dplan):
        logits = forward(params, X, dplan)
        logp = jax.nn.log_softmax(logits)
        onehot = jax.nn.one_hot(labels, model.num_classes)
        return -jnp.mean(jnp.sum(onehot * logp, axis=-1))

    def train_step(params, opt_state, X, labels, dplan):
        loss, grads = jax.value_and_grad(loss_fn)(params, X, labels, dplan)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return tx.init, train_step
