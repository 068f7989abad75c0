"""Zamba2-style hybrid LM: a Mamba2 backbone and one *shared* attention
block applied after every ``attn_every`` SSM layers (the port's
``repro.models.hybrid``; one set of the block's weights, ``n_layers //
attn_every`` applications of it: the Zamba trick).

The layers run as ``n_layers // attn_every`` groups of ``attn_every``
Mamba2 blocks, each group followed by the shared attention-and-MLP block,
then the ``n_layers mod attn_every`` tail blocks: Python loops where the
JAX package scans.  The mixers' intra-chunk products go through
`chunk_einsum` (K2 under "sfc_cuda"), the shared block's projections
through the GEMM backend (K1/K2) and its attention through ``attn_impl``
(K11 / K14 under "sfc", K15 under "flash_pallas"); ``in_proj``,
``out_proj`` and the LM head are plain ``torch.matmul``, as the JAX
package's are plain ``@``.

Parameters keep the JAX tree's names, its stacked axes written out as
module lists: ``groups.{g}.{e}.*`` (``groups`` stacked on (G, E)),
``tail.{i}.*``, ``shared_attn.*`` (`repro_torch.convert` maps one onto the
other).  The cache holds one SSM state and conv tail a Mamba2 block and one
KV cache an application of the shared block, stacked as the JAX package
stacks them; a decode step updates every one of them in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import MLP, cross_entropy_loss, make_norm, normal_, param
from repro_torch.models.remat import check_policy, remat_call

__all__ = ["MambaBlock", "SharedAttention", "HybridLM"]


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 block: ``norm`` and the ``mixer``."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.norm = make_norm(cfg.norm)(cfg.d_model, dtype=dtype, device=device)
        self.mixer = ssm.Mamba2(d_model=cfg.d_model, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                                expand=cfg.ssm_expand, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        self.norm.init()
        self.mixer.init(generator)


class SharedAttention(nn.Module):
    """The shared block: pre-norm GQA attention and a gated MLP."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        norm = make_norm(cfg.norm)
        self.attn = attn.Attention(d_model=cfg.d_model, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                                   head_dim=cfg.head_dim_, **kw)
        self.norm1 = norm(cfg.d_model, **kw)
        self.norm2 = norm(cfg.d_model, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=True, act=cfg.act, **kw)

    def init(self, generator: torch.Generator) -> None:
        self.attn.init(generator)
        self.norm1.init()
        self.norm2.init()
        self.mlp.init(generator)


def _stack_states(states):
    """[{"ssm", "conv"}, ...] -> {"ssm": stacked, "conv": stacked}."""
    return {key: torch.stack([st[key] for st in states]) for key in ("ssm", "conv")}


class HybridLM(nn.Module):
    """Mamba2 layers with a shared attention block: prefill into the SSM,
    conv and KV caches, then one-token decode."""

    def __init__(self, cfg: ArchConfig, *, device, dtype=None):
        super().__init__()
        if cfg.family != "hybrid" or cfg.attn_every <= 0 or cfg.ssm_state <= 0:
            raise ValueError(f"HybridLM needs a hybrid config with attn_every and ssm_state, got {cfg.name!r}")
        self.cfg = cfg
        dtype = torch_dtype(dtype or cfg.param_dtype)
        kw = dict(dtype=dtype, device=device)
        self.n_groups = cfg.n_layers // cfg.attn_every
        self.n_tail = cfg.n_layers - self.n_groups * cfg.attn_every
        self.embed = param((cfg.vocab, cfg.d_model), **kw)
        self.groups = nn.ModuleList(
            [nn.ModuleList([MambaBlock(cfg, **kw) for _ in range(cfg.attn_every)]) for _ in range(self.n_groups)]
        )
        self.shared_attn = SharedAttention(cfg, **kw)
        self.tail = nn.ModuleList([MambaBlock(cfg, **kw) for _ in range(self.n_tail)])
        self.final_norm = make_norm(cfg.norm)(cfg.d_model, **kw)
        self.head = param((cfg.d_model, cfg.vocab), **kw)

    def init(self, generator: torch.Generator) -> "HybridLM":
        """Random weights from ``generator`` (normal x 0.02 embeddings and
        projections, ones for norm scales, the mixers' own rule)."""
        normal_(self.embed, generator)
        for group in self.groups:
            for block in group:
                block.init(generator)
        self.shared_attn.init(generator)
        for block in self.tail:
            block.init(generator)
        self.final_norm.init()
        normal_(self.head, generator)
        return self

    # ---------------- blocks ----------------

    def _mamba_kw(self) -> Dict[str, int]:
        return dict(d_state=self.cfg.ssm_state, head_dim=self.cfg.ssm_head_dim)

    def _mamba_block(self, block: MambaBlock, x, *, return_state: bool = False):
        out = ssm.mamba2_forward(block.mixer, block.norm(x), chunk=self.cfg.ssm_chunk, return_state=return_state,
                                 **self._mamba_kw())
        if return_state:
            out, st = out
            return x + out, st
        return x + out

    def _mamba_block_decode(self, block: MambaBlock, x, state):
        out, st = ssm.mamba2_decode(block.mixer, block.norm(x), state, **self._mamba_kw())
        return x + out, st

    def _attn_kw(self) -> Dict[str, Any]:
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, rope_theta=cfg.rope_theta, attn_impl=cfg.attn_impl)

    def _attn_block(self, x, *, cache_len: Optional[int] = None):
        """The shared block over a sequence; with ``cache_len`` a prefill
        that also returns its KV cache."""
        sa, cfg = self.shared_attn, self.cfg
        h = sa.norm1(x)
        chunks = dict(q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
        if cache_len is None:
            a, cache = attn.attention_forward(sa.attn, h, causal=True, **chunks, **self._attn_kw()), None
        else:
            a, cache = attn.attention_prefill(sa.attn, h, cache_len=cache_len, **chunks, **self._attn_kw())
        x = x + a
        return x + sa.mlp(sa.norm2(x)), cache

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.final_norm(x), self.head)

    # ---------------- entry points ----------------

    def _group(self, group: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
        """A group of Mamba2 blocks and the shared block (JAX's remat unit)."""
        for block in group:
            x = self._mamba_block(block, x)
        return self._attn_block(x)[0]

    def forward(self, tokens: torch.Tensor, *, remat: str = "dots") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training forward: (logits (B, S, V), {}), no auxiliary loss.
        Each group (its Mamba2 blocks and the shared block) and each tail
        block is one remat unit under ``remat`` (`models.remat`; the JAX
        package's default, "dots")."""
        check_policy(remat)
        x = self.embed[tokens]
        for group in self.groups:
            x = remat_call(functools.partial(self._group, group), remat, x)
        for block in self.tail:
            x = remat_call(functools.partial(self._mamba_block, block), remat, x)
        return self._logits(x), {}

    def loss(self, batch: Dict[str, torch.Tensor], *, remat: str = "dots") -> torch.Tensor:
        """The f32 cross entropy of the forward's logits on ``{"tokens",
        "labels": (B, S)}``; ``remat`` as `forward`'s."""
        logits, _ = self.forward(batch["tokens"].long(), remat=remat)
        return cross_entropy_loss(logits, batch["labels"])

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, cache_len: int,
                remat: str = "dots") -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Prefill (B, S) tokens: (last-position logits (B, V), cache).  The
        cache is ``{"mamba": {"ssm": (G, E, B, H, N, P) f32, "conv": (G, E,
        B, W - 1, conv_dim)}, "tail": the same stacked on (n_tail, ...) or
        None, "kv": {"k", "v": (G, B, cache_len, Hkv, D)}, "index": S}``,
        the JAX package's layout.  ``remat`` is accepted as the JAX
        package's; without gradients it changes nothing."""
        check_policy(remat)
        s = tokens.shape[1]
        x = self.embed[tokens]
        group_states, ks, vs = [], [], []
        for group in self.groups:
            states = []
            for block in group:
                x, st = self._mamba_block(block, x, return_state=True)
                states.append(st)
            group_states.append(_stack_states(states))
            x, kv = self._attn_block(x, cache_len=cache_len)
            ks.append(kv["k"])
            vs.append(kv["v"])
        tail_states = []
        for block in self.tail:
            x, st = self._mamba_block(block, x, return_state=True)
            tail_states.append(st)
        logits = self._logits(x[:, -1:])[:, 0]
        cache = {
            "mamba": _stack_states(group_states),
            "tail": _stack_states(tail_states) if tail_states else None,
            "kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
            "index": s,
        }
        return logits, cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-token decode of (B, 1) tokens at ``cache["index"]``.  Every
        SSM state, conv tail and KV cache is updated in place; the returned
        dict shares them and carries ``index + 1``."""
        index = int(cache["index"])
        kv = cache["kv"]
        if index >= kv["k"].shape[2]:
            raise ValueError(f"KV cache of length {kv['k'].shape[2]} is full")
        mamba, tail = cache["mamba"], cache["tail"]

        def step(block, x, states, *at):
            x, st = self._mamba_block_decode(block, x, {key: states[key][at] for key in ("ssm", "conv")})
            for key in ("ssm", "conv"):
                states[key][at].copy_(st[key])
            return x

        sa = self.shared_attn
        x = self.embed[token]
        for g, group in enumerate(self.groups):
            for e, block in enumerate(group):
                x = step(block, x, mamba, g, e)
            layer_cache = {"k": kv["k"][g], "v": kv["v"][g]}
            a, _ = attn.attention_decode(sa.attn, sa.norm1(x), layer_cache, index, **self._attn_kw())
            x = x + a
            x = x + sa.mlp(sa.norm2(x))
        for i, block in enumerate(self.tail):
            x = step(block, x, tail, i)
        logits = self._logits(x)[:, 0]
        return logits, {"mamba": mamba, "tail": tail, "kv": kv, "index": index + 1}
