"""Sparse-attention sequence transformer — second flagship model family.

The reference README motivates SDDMM with "graph attention networks and
sparse transformers" (reference README.md:6-10). models/graph_transformer
covers the GNN side; this module is the sequence side: a decoder-style
transformer whose attention is restricted to a *fixed sparse mask* (causal
local window + strided global summaries, the Sparse Transformers /
Longformer family of patterns). The mask is a CSR matrix, so the whole
BSMR pipeline applies: the mask is reordered, packed into tiles once,
and every layer/head/step runs the hybrid SDDMM for its attention logits.

Banded masks are the framework's best regime (natural column blocks →
zero-gather BSR tiles), which is exactly why fixed-pattern sparse
attention is the killer app for this kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bsmr_sddmm_tpu.config import SddmmConfig
from bsmr_sddmm_tpu.formats import COO, CSR
from bsmr_sddmm_tpu.ops.graph_rphm import make_sparse_attention_rphm
from bsmr_sddmm_tpu.ops.sddmm import DevicePlan, device_plan, make_sddmm_body
from bsmr_sddmm_tpu.pack import TilePlan, pack_tiles
from bsmr_sddmm_tpu.reorder import bsmr


def local_strided_mask(seq_len: int, window: int = 128,
                       stride: int = 64) -> CSR:
    """Causal attention mask: each position attends to the previous
    ``window`` positions plus every ``stride``-th earlier position (the
    Sparse Transformers "strided" pattern). Values are 1."""
    rows_parts, cols_parts = [], []
    q = np.arange(seq_len, dtype=np.int64)
    # local band (causal)
    for off in range(window):
        keep = q - off >= 0
        rows_parts.append(q[keep])
        cols_parts.append(q[keep] - off)
    # strided summaries
    n_glob = seq_len // stride
    if n_glob:
        g = (np.arange(n_glob, dtype=np.int64) + 1) * stride - 1
        for gc in g:
            keep = q > gc + window - 1  # beyond the local band
            rows_parts.append(q[keep])
            cols_parts.append(np.full(int(keep.sum()), gc, np.int64))
    rows = np.concatenate(rows_parts)
    cols = np.concatenate(cols_parts)
    keys = rows * np.int64(seq_len) + cols
    uniq = np.unique(keys)
    ri = (uniq // seq_len).astype(np.int32)
    ci = (uniq % seq_len).astype(np.int32)
    return COO(seq_len, seq_len, ri, ci,
               np.ones(uniq.shape[0], np.float32)).to_csr()


@dataclasses.dataclass(frozen=True)
class SparseTransformer:
    """Static model description bound to one attention mask."""

    seq_len: int
    vocab_size: int
    head_dim: int
    num_heads: int = 4
    num_layers: int = 2

    @property
    def model_dim(self) -> int:
        return self.head_dim * self.num_heads


def init_params(model: SparseTransformer, seed: int = 0) -> Dict:
    rng = np.random.default_rng(seed)
    d = model.model_dim

    def dense(shape, scale=None):
        scale = scale or (1.0 / np.sqrt(shape[0]))
        return jnp.asarray(rng.normal(0, scale, shape), jnp.float32)

    params = {
        "embed": dense((model.vocab_size, d), scale=0.02),
        "pos": dense((model.seq_len, d), scale=0.02),
    }
    for L in range(model.num_layers):
        params[f"layer_{L}"] = {
            "wq": dense((d, d)), "wk": dense((d, d)), "wv": dense((d, d)),
            "wo": dense((d, d)),
            "ln1_scale": jnp.ones(d), "ln1_bias": jnp.zeros(d),
            "ln2_scale": jnp.ones(d), "ln2_bias": jnp.zeros(d),
            "mlp_in": dense((d, 4 * d)), "mlp_out": dense((4 * d, d)),
        }
    params["unembed"] = dense((d, model.vocab_size))
    return params


def _layer_norm(x, scale, bias, eps=1e-6):
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * scale + bias


def make_forward(model: SparseTransformer,
                 mask: Optional[CSR] = None,
                 config: Optional[SddmmConfig] = None,
                 window: int = 128, stride: int = 64
                 ) -> Tuple[Callable, DevicePlan, TilePlan]:
    """Build ``forward(params, tokens, dplan) -> logits`` with the sparse
    attention bound to the packed mask plan. ``tokens`` is (seq_len,)
    int32; returns (seq_len, vocab) next-token logits."""
    mask = mask if mask is not None else local_strided_mask(
        model.seq_len, window=window, stride=stride)
    config = config or SddmmConfig(k=model.head_dim, delta=0.05)
    config = config.replace(k=model.head_dim)
    reord = bsmr(mask, config)
    plan = pack_tiles(mask, reord, config, k=model.head_dim)
    # tile-native attention (see ops/graph_rphm.py): no CSR round trip
    body = make_sddmm_body(plan, config, emit="rphm")
    head_fn = make_sparse_attention_rphm(plan, body)
    n = mask.rows

    def attention(lp, x, dplan):
        d, h, hd = model.model_dim, model.num_heads, model.head_dim
        q = (x @ lp["wq"]).reshape(n, h, hd)
        kk = (x @ lp["wk"]).reshape(n, h, hd)
        v = (x @ lp["wv"]).reshape(n, h, hd)
        # static loop over heads: the per-head body is traced once per
        # head and shares one plan (a batched head axis is future work)
        heads = jnp.stack([head_fn(q[:, h_], kk[:, h_], v[:, h_], dplan)
                           for h_ in range(h)], axis=1)
        return heads.reshape(n, d) @ lp["wo"]

    def forward(params, tokens, dplan):
        x = jnp.take(params["embed"], tokens, axis=0) + params["pos"]
        for L in range(model.num_layers):
            lp = params[f"layer_{L}"]
            x = x + attention(
                lp, _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"]), dplan)
            hmid = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"])
            x = x + jax.nn.gelu(hmid @ lp["mlp_in"]) @ lp["mlp_out"]
        return x @ params["unembed"]

    return forward, device_plan(plan), plan


def make_train_step(model: SparseTransformer, forward: Callable,
                    learning_rate: float = 1e-3) -> Tuple[Callable, Callable]:
    """Next-token cross-entropy training step (optax adam):
    ``train_step(params, opt_state, tokens, dplan) ->
    (params, opt_state, loss)``."""
    import optax
    tx = optax.adam(learning_rate)

    def loss_fn(params, tokens, dplan):
        logits = forward(params, tokens, dplan)      # (S, V)
        logp = jax.nn.log_softmax(logits[:-1])
        tgt = tokens[1:]
        nll = -jnp.take_along_axis(logp, tgt[:, None], axis=1)
        return jnp.mean(nll)

    def train_step(params, opt_state, tokens, dplan):
        loss, grads = jax.value_and_grad(loss_fn)(params, tokens, dplan)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return tx.init, train_step
