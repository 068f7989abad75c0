"""Decoder-only transformer LM, dense and MoE families (the port's
``repro.models.transformer.DecoderLM``).  A config with ``n_experts``
replaces each block's MLP by a `models.moe.MoE` layer.

Parameters keep the JAX package's layout: projection weights are (in, out),
so the GEMM kernel receives (K, N) as the TPU kernel did, and the per-layer
parameters are indexable — ``model.layers[i]`` here, the leading axis of
the stacked ``layers`` tree there (`repro_torch.convert.params_from_jax`
maps one onto the other).  The layer stack is a Python loop.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import torch_dtype
from repro_torch.core.gemm_backend import matmul as _bmm
from repro_torch.models import attention as attn
from repro_torch.models.layers import MLP, cross_entropy_loss, make_norm, normal_, param
from repro_torch.models.moe import MoE, moe_forward

__all__ = ["Block", "DecoderLM"]


class Block(nn.Module):
    """Pre-norm attention + MLP (or MoE) block."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        norm = make_norm(cfg.norm)
        self.attn = attn.Attention(
            d_model=cfg.d_model,
            n_heads=cfg.n_heads,
            kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim_,
            qkv_bias=cfg.qkv_bias,
            qk_norm=cfg.qk_norm,
            **kw,
        )
        self.norm1 = norm(cfg.d_model, **kw)
        self.norm2 = norm(cfg.d_model, **kw)
        if cfg.n_experts:
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, **kw)
            self.moe_kw = dict(top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp, act=cfg.act, **kw)

    def init(self, generator: torch.Generator) -> None:
        self.attn.init(generator)
        self.norm1.init()
        self.norm2.init()
        (self.moe if hasattr(self, "moe") else self.mlp).init(generator)

    def ffn(self, h: torch.Tensor) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """The MLP (aux None), or the MoE layer and its aux losses."""
        if hasattr(self, "moe"):
            return moe_forward(self.moe, h, **self.moe_kw)
        return self.mlp(h), None


class DecoderLM(nn.Module):
    """Dense or MoE decoder LM: prefill into a KV cache, then one-token
    decode."""

    def __init__(self, cfg: ArchConfig, *, device, dtype=None):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(f"family {cfg.family!r} is not ported yet: ROADMAP queue 1 item 12")
        if cfg.mrope_sections is not None:
            raise NotImplementedError("M-RoPE (VLM backbone) is not ported yet: ROADMAP queue 1 item 12")
        self.cfg = cfg
        dtype = torch_dtype(dtype or cfg.param_dtype)
        kw = dict(dtype=dtype, device=device)
        self.embed = param((cfg.vocab, cfg.d_model), **kw)
        self.layers = nn.ModuleList([Block(cfg, **kw) for _ in range(cfg.n_layers)])
        self.final_norm = make_norm(cfg.norm)(cfg.d_model, **kw)
        if cfg.tie_embeddings:
            self.register_parameter("head", None)
        else:
            self.head = param((cfg.d_model, cfg.vocab), **kw)

    def init(self, generator: torch.Generator) -> "DecoderLM":
        """Random weights from ``generator``: normal x 0.02 for embeddings
        and projections, ones for norm scales, zeros for biases."""
        normal_(self.embed, generator)
        for layer in self.layers:
            layer.init(generator)
        self.final_norm.init()
        if self.head is not None:
            normal_(self.head, generator)
        return self

    # ---------------- embedding / head ----------------

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return _bmm(x, head)

    def _attn_kw(self) -> Dict[str, Any]:
        cfg = self.cfg
        return dict(
            n_heads=cfg.n_heads,
            kv_heads=cfg.kv_heads,
            rope_theta=cfg.rope_theta,
            rotary_pct=cfg.rotary_pct,
            attn_impl=cfg.attn_impl,
        )

    # ---------------- entry points ----------------

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training forward: (logits, aux); aux holds the MoE losses summed
        over the layers, zero for the dense family."""
        cfg = self.cfg
        x = self._embed(tokens)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux_acc = {"moe_aux_loss": zero, "moe_z_loss": zero}
        for layer in self.layers:
            h = layer.norm1(x)
            x = x + attn.attention_forward(
                layer.attn, h, causal=True, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk, **self._attn_kw()
            )
            m, aux = layer.ffn(layer.norm2(x))
            x = x + m
            if aux is not None:
                aux_acc = {k: aux_acc[k] + aux[k] for k in aux_acc}
        return self._logits(x), aux_acc

    def loss(self, batch: Dict[str, torch.Tensor], *, remat: str = "none") -> torch.Tensor:
        """Training loss of a batch ``{"tokens", "labels": (B, S)}``: the
        f32 cross entropy of the forward's logits plus the MoE losses (zero
        for the dense family) over the layer count.  Only ``remat="none"``
        is ported (the JAX package's default is "dots")."""
        if remat != "none":
            raise NotImplementedError(
                f"remat={remat!r} (activation recomputation through torch.utils.checkpoint) is not "
                "ported: ROADMAP queue 1 item 18"
            )
        logits, aux = self.forward(batch["tokens"].long())
        n = self.cfg.n_layers
        return cross_entropy_loss(logits, batch["labels"]) + aux["moe_aux_loss"] / n + aux["moe_z_loss"] / n

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, cache_len: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Prefill (B, S) tokens: (last-position logits (B, V), cache), the
        cache ``{"k", "v": (L, B, cache_len, Hkv, D), "index": S}``."""
        cfg = self.cfg
        s = tokens.shape[1]
        x = self._embed(tokens)
        ks, vs = [], []
        for layer in self.layers:
            h = layer.norm1(x)
            a, cache = attn.attention_prefill(
                layer.attn, h, cache_len=cache_len, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk, **self._attn_kw()
            )
            ks.append(cache["k"])
            vs.append(cache["v"])
            x = x + a
            x = x + layer.ffn(layer.norm2(x))[0]
        logits = self._logits(x[:, -1:])
        return logits[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs), "index": s}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-token decode of (B, 1) tokens at ``cache["index"]``.  The
        cache tensors are updated in place; the returned dict shares them
        and carries ``index + 1``."""
        index = int(cache["index"])
        if index >= cache["k"].shape[2]:
            raise ValueError(f"KV cache of length {cache['k'].shape[2]} is full")
        x = self._embed(token)
        for i, layer in enumerate(self.layers):
            h = layer.norm1(x)
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
            a, _ = attn.attention_decode(layer.attn, h, layer_cache, index, **self._attn_kw())
            x = x + a
            x = x + layer.ffn(layer.norm2(x))[0]
        logits = self._logits(x)
        return logits[:, 0], {"k": cache["k"], "v": cache["v"], "index": index + 1}
