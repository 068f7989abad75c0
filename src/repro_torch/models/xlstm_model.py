"""xLSTM LM (xlstm-1.3b; the port's ``repro.models.xlstm_model``): groups
of ``slstm_every - 1`` mLSTM blocks followed by one sLSTM block (48 = 6 x 8
with ``slstm_every`` 8), Python loops where the JAX package scans.  d_ff
= 0: the blocks carry their own projections, no MLP.  The mLSTM blocks'
intra-chunk products run on K2 under "sfc_cuda" (`models.xlstm`); the
projections and the LM head are plain ``torch.matmul``, as the JAX
package's are plain ``@``.

Parameters keep the JAX tree's names, its stacked axes written out as
module lists: ``mlstm.{g}.{m}.*`` (``mlstm`` stacked on (G, M)) and
``slstm.{g}.*`` (`repro_torch.convert` maps one onto the other).  The
"cache" of a prefill is the recurrent state, O(1) in the sequence length,
stacked as the JAX package stacks it; a decode step updates it in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import torch_dtype
from repro_torch.models import xlstm
from repro_torch.models.layers import cross_entropy_loss, make_norm, normal_, param
from repro_torch.models.remat import check_policy, remat_call

__all__ = ["XLSTMLM"]


class XLSTMLM(nn.Module):
    """mLSTM / sLSTM groups: prefill into the recurrent state, then
    one-token decode."""

    def __init__(self, cfg: ArchConfig, *, device, dtype=None):
        super().__init__()
        if cfg.family != "ssm" or cfg.slstm_every < 2 or cfg.n_layers % cfg.slstm_every:
            raise ValueError(f"XLSTMLM needs an ssm config whose slstm_every (>= 2) divides n_layers, "
                             f"got {cfg.name!r}")
        self.cfg = cfg
        dtype = torch_dtype(dtype or cfg.param_dtype)
        kw = dict(d_model=cfg.d_model, n_heads=cfg.n_heads, dtype=dtype, device=device)
        self.n_groups = cfg.n_layers // cfg.slstm_every
        self.m_per_group = cfg.slstm_every - 1
        self.embed = param((cfg.vocab, cfg.d_model), dtype=dtype, device=device)
        self.mlstm = nn.ModuleList(
            [nn.ModuleList([xlstm.MLSTMBlock(**kw) for _ in range(self.m_per_group)]) for _ in range(self.n_groups)]
        )
        self.slstm = nn.ModuleList([xlstm.SLSTMBlock(**kw) for _ in range(self.n_groups)])
        self.final_norm = make_norm(cfg.norm)(cfg.d_model, dtype=dtype, device=device)
        self.head = param((cfg.d_model, cfg.vocab), dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> "XLSTMLM":
        """Random weights from ``generator`` (normal x 0.02 embeddings and
        head, the blocks' own rule, ones for the final norm)."""
        normal_(self.embed, generator)
        for group, s_block in zip(self.mlstm, self.slstm):
            for block in group:
                block.init(generator)
            s_block.init(generator)
        self.final_norm.init()
        normal_(self.head, generator)
        return self

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.final_norm(x), self.head)

    # ---------------- entry points ----------------

    def _group(self, group: nn.ModuleList, s_block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """A group of mLSTM blocks and its sLSTM block (JAX's remat unit)."""
        cfg = self.cfg
        for block in group:
            x = xlstm.mlstm_block_forward(block, x, n_heads=cfg.n_heads, chunk=cfg.ssm_chunk)
        return xlstm.slstm_block_forward(s_block, x, n_heads=cfg.n_heads)

    def forward(self, tokens: torch.Tensor, *, remat: str = "dots") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training forward: (logits (B, S, V), {}), no auxiliary loss.
        Each group is one remat unit under ``remat`` (`models.remat`; the
        JAX package's default, "dots")."""
        check_policy(remat)
        x = self.embed[tokens]
        for group, s_block in zip(self.mlstm, self.slstm):
            x = remat_call(functools.partial(self._group, group, s_block), remat, x)
        return self._logits(x), {}

    def loss(self, batch: Dict[str, torch.Tensor], *, remat: str = "dots") -> torch.Tensor:
        """The f32 cross entropy of the forward's logits on ``{"tokens",
        "labels": (B, S)}``; ``remat`` as `forward`'s."""
        logits, _ = self.forward(batch["tokens"].long(), remat=remat)
        return cross_entropy_loss(logits, batch["labels"])

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, cache_len: int = 0,
                remat: str = "dots") -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Prefill (B, S) tokens: (last-position logits (B, V), cache).  The
        cache is the recurrent state, ``{"mlstm_core": (C (G, M, B, H, P,
        P), n (G, M, B, H, P), m (G, M, B, H)) in f32, "mlstm_conv": (G, M,
        B, W - 1, d_inner), "slstm": (c, n, m, h) each (G, B, H, P) f32,
        "index": S}``, the JAX package's layout.  ``cache_len`` is accepted
        for the engine's interface and ignored, as in the JAX package, and
        so is ``remat`` without gradients."""
        del cache_len
        check_policy(remat)
        cfg = self.cfg
        x = self.embed[tokens]
        cores, convs, s_states = [], [], []
        for group, s_block in zip(self.mlstm, self.slstm):
            g_cores, g_convs = [], []
            for block in group:
                x, (core, conv) = xlstm.mlstm_block_forward(block, x, n_heads=cfg.n_heads, chunk=cfg.ssm_chunk,
                                                            return_state=True)
                g_cores.append(core)
                g_convs.append(conv)
            cores.append([torch.stack(parts) for parts in zip(*g_cores)])
            convs.append(torch.stack(g_convs))
            x, st = xlstm.slstm_block_forward(s_block, x, n_heads=cfg.n_heads, return_state=True)
            s_states.append(st)
        logits = self._logits(x[:, -1:])[:, 0]
        cache = {
            "mlstm_core": tuple(torch.stack(parts) for parts in zip(*cores)),
            "mlstm_conv": torch.stack(convs),
            "slstm": tuple(torch.stack(parts) for parts in zip(*s_states)),
            "index": tokens.shape[1],
        }
        return logits, cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-token decode of (B, 1) tokens.  Every state tensor of the
        cache is updated in place; the returned dict shares them and
        carries ``index + 1``."""
        cfg = self.cfg
        core, conv, s_state = cache["mlstm_core"], cache["mlstm_conv"], cache["slstm"]
        x = self.embed[token]
        for g, (group, s_block) in enumerate(zip(self.mlstm, self.slstm)):
            for e, block in enumerate(group):
                x, (new_core, new_conv) = xlstm.mlstm_block_decode(
                    block, x, (tuple(t[g, e] for t in core), conv[g, e]), n_heads=cfg.n_heads)
                for t, new in zip(core, new_core):
                    t[g, e].copy_(new)
                conv[g, e].copy_(new_conv)
            x, new_s = xlstm.slstm_block_decode(s_block, x, tuple(t[g] for t in s_state), n_heads=cfg.n_heads)
            for t, new in zip(s_state, new_s):
                t[g].copy_(new)
        logits = self._logits(x)[:, 0]
        return logits, {**cache, "index": int(cache["index"]) + 1}
