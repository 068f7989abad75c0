"""Encoder-decoder transformer (the seamless-m4t-medium backbone; the port's
``repro.models.encdec``).

The audio / text frontend is a stub, as in the JAX package: the encoder
takes precomputed frame embeddings (B, S_enc, d_model).  Encoder:
bidirectional self-attention.  Decoder: causal self-attention and
cross-attention over the encoder's memory; token embedding and LM head.
Every projection goes through the GEMM backend (K1/K2 under "sfc_cuda"),
the attention through ``attn_impl`` (K11 for the encoder's, the decoder's
and the cross-attention's prefill, K14 for both decode attentions under
"sfc"); the LM head is plain ``torch.matmul``, as the JAX package's is
plain ``@``.

Parameters keep the JAX tree's names, its stacked axes written out as
module lists: ``encoder.{i}.*`` and ``decoder.{i}.*``
(`repro_torch.convert`).  A prefill returns the decoder's KV caches and
the memory's cross k / v, stacked on the layer axis as the JAX package
stacks them; a decode step writes its self-attention k / v in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.layers import MLP, cross_entropy_loss, make_norm, normal_, param
from repro_torch.models.remat import check_policy, remat_call

__all__ = ["EncoderLayer", "DecoderLayer", "EncDecLM"]


def _attention(cfg: ArchConfig, kw) -> attn.Attention:
    return attn.Attention(d_model=cfg.d_model, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim_,
                          **kw)


class EncoderLayer(nn.Module):
    """Pre-norm bidirectional self-attention and MLP."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        norm = make_norm(cfg.norm)
        self.attn = _attention(cfg, kw)
        self.norm1 = norm(cfg.d_model, **kw)
        self.norm2 = norm(cfg.d_model, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp, act=cfg.act, **kw)

    def init(self, generator: torch.Generator) -> None:
        self.attn.init(generator)
        self.norm1.init()
        self.norm2.init()
        self.mlp.init(generator)


class DecoderLayer(EncoderLayer):
    """Pre-norm causal self-attention, cross-attention (``cross``, its
    norm ``norm_x``) and MLP."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__(cfg, dtype=dtype, device=device)
        self.cross = _attention(cfg, dict(dtype=dtype, device=device))
        self.norm_x = make_norm(cfg.norm)(cfg.d_model, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        super().init(generator)
        self.cross.init(generator)
        self.norm_x.init()


class EncDecLM(nn.Module):
    """Encoder over stub frame embeddings, decoder over tokens: encode and
    prefill into the decoder's caches, then one-token decode."""

    def __init__(self, cfg: ArchConfig, *, device, dtype=None):
        super().__init__()
        if not cfg.is_encoder_decoder or cfg.encoder_layers <= 0:
            raise ValueError(f"EncDecLM needs an encoder-decoder config, got {cfg.name!r}")
        self.cfg = cfg
        dtype = torch_dtype(dtype or cfg.param_dtype)
        kw = dict(dtype=dtype, device=device)
        norm = make_norm(cfg.norm)
        self.embed = param((cfg.vocab, cfg.d_model), **kw)
        self.encoder = nn.ModuleList([EncoderLayer(cfg, **kw) for _ in range(cfg.encoder_layers)])
        self.decoder = nn.ModuleList([DecoderLayer(cfg, **kw) for _ in range(cfg.n_layers)])
        self.enc_norm = norm(cfg.d_model, **kw)
        self.final_norm = norm(cfg.d_model, **kw)
        self.head = param((cfg.d_model, cfg.vocab), **kw)

    def init(self, generator: torch.Generator) -> "EncDecLM":
        """Random weights from ``generator`` (normal x 0.02 embeddings and
        projections, ones for norm scales)."""
        normal_(self.embed, generator)
        for layer in (*self.encoder, *self.decoder):
            layer.init(generator)
        self.enc_norm.init()
        self.final_norm.init()
        normal_(self.head, generator)
        return self

    def _kw(self, positions: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        cfg = self.cfg
        kw = dict(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk,
                  k_chunk=cfg.k_chunk, attn_impl=cfg.attn_impl)
        return kw if positions is None else dict(kw, positions=positions)

    @staticmethod
    def _positions(b: int, s: int, device) -> torch.Tensor:
        return torch.arange(s, device=device)[None].expand(b, s)

    # ---------------- encoder ----------------

    def _enc_layer(self, layer: EncoderLayer, kw: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        x = x + attn.attention_forward(layer.attn, layer.norm1(x), causal=False, **kw)
        return x + layer.mlp(layer.norm2(x))

    def encode(self, src_embeds: torch.Tensor, *, remat: str = "dots") -> torch.Tensor:
        """The encoder's memory (B, S_enc, d_model) of the frame embeddings,
        cast to the model's type first.  Each encoder layer is one remat
        unit under ``remat`` (`models.remat`)."""
        check_policy(remat)
        x = src_embeds.to(self.embed.dtype)
        b, s, _ = x.shape
        kw = self._kw(self._positions(b, s, x.device))
        for layer in self.encoder:
            x = remat_call(functools.partial(self._enc_layer, layer, kw), remat, x)
        return self.enc_norm(x)

    # ---------------- decoder ----------------

    def _dec_block(self, layer: DecoderLayer, x, memory, positions, *, cache_len: Optional[int] = None):
        """A decoder layer over a sequence; with ``cache_len`` a prefill that
        also returns its self-attention KV cache."""
        cfg = self.cfg
        kw = self._kw(positions)
        h = layer.norm1(x)
        if cache_len is None:
            a, cache = attn.attention_forward(layer.attn, h, causal=True, **kw), None
        else:
            a, cache = attn.attention_prefill(layer.attn, h, cache_len=cache_len, **kw)
        x = x + a
        x = x + attn.cross_attention_forward(layer.cross, layer.norm_x(x), memory, n_heads=cfg.n_heads,
                                             kv_heads=cfg.kv_heads, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
                                             attn_impl=cfg.attn_impl)
        return x + layer.mlp(layer.norm2(x)), cache

    def _dec_layer(self, layer: DecoderLayer, memory, positions, x: torch.Tensor) -> torch.Tensor:
        return self._dec_block(layer, x, memory, positions)[0]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.final_norm(x), self.head)

    # ---------------- entry points ----------------

    def forward(self, tokens: torch.Tensor, src_embeds: torch.Tensor, *,
                remat: str = "dots") -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Training forward of (B, S_dec) decoder tokens over (B, S_enc,
        d_model) frame embeddings: (logits (B, S_dec, V), {}).  Each encoder
        and each decoder layer is one remat unit under ``remat``
        (`models.remat`; the JAX package's default, "dots"), the memory an
        input of every decoder layer's."""
        memory = self.encode(src_embeds, remat=remat)
        b, s = tokens.shape
        positions = self._positions(b, s, tokens.device)
        x = self.embed[tokens]
        for layer in self.decoder:
            x = remat_call(functools.partial(self._dec_layer, layer, memory, positions), remat, x)
        return self._logits(x), {}

    def loss(self, batch: Dict[str, torch.Tensor], *, remat: str = "dots") -> torch.Tensor:
        """The f32 cross entropy of the forward's logits on ``{"tokens",
        "src_embeds", "labels"}``; ``remat`` as `forward`'s."""
        logits, _ = self.forward(batch["tokens"].long(), batch["src_embeds"], remat=remat)
        return cross_entropy_loss(logits, batch["labels"])

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, src_embeds: torch.Tensor, *,
                cache_len: int, remat: str = "dots") -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Encode, then prefill (B, S) decoder tokens: (last-position logits
        (B, V), cache).  The cache is ``{"kv": {"k", "v": (L, B, cache_len,
        Hkv, D)}, "mem_kv": {"k", "v": (L, B, S_enc, Hkv, D)}, "mem_len":
        S_enc, "index": S}``, the JAX package's layout.  As there, each
        layer projects the memory's k / v twice: in its cross-attention and
        once more for the cache.  ``remat`` is accepted as the JAX
        package's; without gradients it changes nothing."""
        cfg = self.cfg
        memory = self.encode(src_embeds, remat=remat)
        b, s = tokens.shape
        positions = self._positions(b, s, tokens.device)
        x = self.embed[tokens]
        self_kv, mem_kv = [], []
        for layer in self.decoder:
            x, cache = self._dec_block(layer, x, memory, positions, cache_len=cache_len)
            self_kv.append(cache)
            mem_kv.append(attn.precompute_cross_kv(layer.cross, memory, kv_heads=cfg.kv_heads))
        logits = self._logits(x[:, -1:])[:, 0]
        cache = {
            "kv": {key: torch.stack([c[key] for c in self_kv]) for key in ("k", "v")},
            "mem_kv": {key: torch.stack([c[key] for c in mem_kv]) for key in ("k", "v")},
            "mem_len": memory.shape[1],
            "index": s,
        }
        return logits, cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-token decode of (B, 1) tokens at ``cache["index"]``: the self
        KV caches are written in place; the returned dict shares them and
        carries ``index + 1``."""
        cfg = self.cfg
        index = int(cache["index"])
        kv, mem_kv = cache["kv"], cache["mem_kv"]
        if index >= kv["k"].shape[2]:
            raise ValueError(f"KV cache of length {kv['k'].shape[2]} is full")
        kw = dict(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, attn_impl=cfg.attn_impl)
        x = self.embed[token]
        for i, layer in enumerate(self.decoder):
            a, _ = attn.attention_decode(layer.attn, layer.norm1(x), {"k": kv["k"][i], "v": kv["v"][i]}, index,
                                         rope_theta=cfg.rope_theta, **kw)
            x = x + a
            x = x + attn.cross_attention_decode(layer.cross, layer.norm_x(x), {"k": mem_kv["k"][i],
                                                                              "v": mem_kv["v"][i]},
                                                cache["mem_len"], **kw)
            x = x + layer.mlp(layer.norm2(x))
        logits = self._logits(x)[:, 0]
        return logits, {**cache, "index": index + 1}
