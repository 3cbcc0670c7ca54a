"""Model assembly for decoders of ``attn`` and ``ssm`` blocks.

Port of ``repro.models.transformer`` for the dense decoders (qwen3, phi4,
...) and the attention-free Mamba2 stack (mamba2-1.3b). The reference
stacks parameters over pattern repetitions and scans; PyTorch runs
eagerly, so the port keeps one :class:`Block` per layer in an
``nn.ModuleList`` (layer ``r·|pattern| + j`` is repetition ``r`` of
pattern position ``j``).

Entry points, as in the reference:
* :func:`forward_prefill` — last-token logits + populated caches;
* :func:`forward_decode` — one token against the caches (serve step).

Caches are one dict per layer: ``{"k", "v"}`` (B, S, Kv, hd) for ``attn``,
holding post-RoPE keys, and ``{"conv": (B, w-1, d_inner+2GN) in the model
dtype, "state": (B, H, P, N) f32}`` for ``ssm``. Unlike the reference's
functional updates, the port preallocates them (k/v at the serving
capacity) and updates them in place at every decoded token.

Other block kinds and the encoder-decoder stack raise
``NotImplementedError``: they are later slices of the port (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .attention import attention_output, blockwise_attention, decode_attention, project_qkv
from .config import ATTN, SSM, ModelConfig
from .layers import dense_init, init_attention, init_mlp, rms_norm, swiglu
from .ssm import init_mamba2, mamba2_decode_step, mamba2_mixer

Cache = Dict[str, torch.Tensor]

_NOT_PORTED = {
    "attn_moe": "MoE blocks (ROADMAP.md, Queue 1, slice 4)",
    "ssm_moe": "hybrid SSM+MoE blocks (ROADMAP.md, Queue 1, slice 4)",
    "ssm_mlp": "hybrid SSM blocks (ROADMAP.md, Queue 1, slice 4)",
    "cross": "cross-attention blocks (ROADMAP.md, Queue 1, slice 4)",
}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice has not ported."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP.md, Queue 1, slice 4)")
    for kind in cfg.layout_pattern:
        if kind not in (ATTN, SSM):
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet: {_NOT_PORTED[kind]}")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _frozen_dict(tensors: Dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in tensors.items()})


class Block(nn.Module):
    """One block: pre-norm self-attention (``attn``) or Mamba2 mixer
    (``ssm``), then a pre-norm SwiGLU where the block has one."""

    def __init__(self, kind: str, tensors: Dict) -> None:
        super().__init__()
        self.kind = kind
        self.ln1 = _frozen(tensors["ln1"])
        self.attn = _frozen_dict(tensors["attn"]) if kind == ATTN else None
        self.ssm = _frozen_dict(tensors["ssm"]) if kind == SSM else None
        self.ln2: Optional[nn.Parameter] = None
        self.mlp: Optional[nn.ParameterDict] = None
        if "mlp" in tensors:
            self.ln2 = _frozen(tensors["ln2"])
            self.mlp = _frozen_dict(tensors["mlp"])

    def ffn(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        if self.mlp is None:
            return x
        h = rms_norm(x, self.ln2, eps)
        return x + swiglu(h, self.mlp["w_gate"], self.mlp["w_up"], self.mlp["w_down"])


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Block kind of every layer: the pattern, repeated."""
    pattern = cfg.layout_pattern
    return [pattern[layer % len(pattern)] for layer in range(cfg.num_layers)]


class Transformer(nn.Module):
    """Weights of a decoder, in the reference's layouts."""

    def __init__(self, cfg: ModelConfig, tensors: Dict) -> None:
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg.validate()
        self.embed = _frozen(tensors["embed"])                 # (V, D)
        self.final_norm = _frozen(tensors["final_norm"])
        self.head = None if cfg.tie_embeddings else _frozen(tensors["head"])   # (D, V)
        if len(tensors["blocks"]) != cfg.num_layers:
            raise ValueError(f"{len(tensors['blocks'])} blocks for {cfg.num_layers} layers")
        self.blocks = nn.ModuleList(
            Block(kind, t) for kind, t in zip(layer_kinds(cfg), tensors["blocks"]))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.head is None else self.head
        return x @ head


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[torch.device | str] = None) -> Transformer:
    """Random weights with the reference's distributions, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    check_supported(cfg)                 # before drawing any weights
    dt = _dtype(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tensors: Dict = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02, dtype=dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        tensors["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype=dt)
    blocks = []
    for kind in layer_kinds(cfg):
        blk: Dict = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=dev)}
        if kind == SSM:                  # the mixer is the whole block: no FFN
            blk["ssm"] = init_mamba2(
                gen, cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                cfg.ssm_groups, cfg.ssm_conv_width, dtype=dt)
        else:
            blk["attn"] = init_attention(
                gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, dtype=dt)
        if kind == ATTN and cfg.d_ff:
            blk["ln2"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
            blk["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dt)
        blocks.append(blk)
    tensors["blocks"] = blocks
    return Transformer(cfg, tensors)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _caches(cfg: ModelConfig, batch: int, slots: int, dtype: torch.dtype,
            device: torch.device) -> List[Cache]:
    """Zeroed caches, one dict per layer, by block kind; ``slots`` k/v
    positions for ``attn``."""
    kv = (batch, slots, cfg.num_kv_heads, cfg.resolved_head_dim)
    conv = (batch, cfg.ssm_conv_width - 1, cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
    state = (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    caches = []
    for kind in layer_kinds(cfg):
        if kind == SSM:
            caches.append({"conv": torch.zeros(conv, dtype=dtype, device=device),
                           "state": torch.zeros(state, dtype=torch.float32, device=device)})
        else:
            caches.append({"k": torch.zeros(kv, dtype=dtype, device=device),
                           "v": torch.zeros(kv, dtype=dtype, device=device)})
    return caches


def init_cache(cfg: ModelConfig, batch: int, max_cache_len: int,
               dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device | str] = None) -> List[Cache]:
    """Empty serving caches for :func:`forward_decode`; sliding-window
    models keep only the window."""
    check_supported(cfg)
    slots = min(max_cache_len, cfg.sliding_window) if cfg.sliding_window else max_cache_len
    return _caches(cfg, batch, slots, dtype or _dtype(cfg), resolve_device(device))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward_prefill(model: Transformer, tokens: torch.Tensor,
                    max_cache_len: int) -> Tuple[torch.Tensor, List[Cache], int]:
    """Returns (last-token logits (B, 1, V), caches, cache_len).

    The k/v caches hold ``max(max_cache_len, S)`` slots, the prompt's
    post-RoPE k/v first and zeros after; the SSM caches hold the conv and
    scan states after the prompt.
    """
    cfg = model.cfg
    b, s = tokens.shape
    x = model.embed[tokens]
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    caches = _caches(cfg, b, max(max_cache_len, s), x.dtype, x.device)
    for blk, cache in zip(model.blocks, caches):
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        if blk.kind == SSM:
            y, (conv, state) = mamba2_mixer(blk.ssm, h, cfg, return_state=True)
            cache["conv"].copy_(conv)
            cache["state"].copy_(state)
        else:
            q, k, v = project_qkv(blk.attn, h, pos, cfg.rope_theta, cfg.qk_norm,
                                  use_rope=True, norm_eps=cfg.norm_eps)
            attn = blockwise_attention(q, k, v, causal=True, window=cfg.sliding_window)
            y = attention_output(blk.attn, attn)
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
        x = blk.ffn(x + y, cfg.norm_eps)
    return model.logits(x[:, -1:]), caches, s


def forward_decode(model: Transformer, token: torch.Tensor, caches: List[Cache],
                   cache_len: int) -> Tuple[torch.Tensor, List[Cache], int]:
    """One new token (B, 1) against ``caches`` (updated in place).

    Returns (logits (B, 1, V), caches, cache_len + 1).
    """
    cfg = model.cfg
    b = token.shape[0]
    x = model.embed[token]
    pos = torch.full((b, 1), cache_len, dtype=torch.long, device=token.device)
    for blk, cache in zip(model.blocks, caches):
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        if blk.kind == SSM:
            y, (conv, state) = mamba2_decode_step(blk.ssm, h, cfg, cache["conv"],
                                                  cache["state"])
            cache["conv"].copy_(conv)
            cache["state"].copy_(state)
        else:
            slots = cache["k"].shape[1]
            write_pos = cache_len % slots if cfg.sliding_window else cache_len
            if write_pos >= slots:
                raise ValueError(f"cache full: {slots} slots, writing position {write_pos}")
            q, k, v = project_qkv(blk.attn, h, pos, cfg.rope_theta, cfg.qk_norm,
                                  use_rope=True, norm_eps=cfg.norm_eps)
            cache["k"][:, write_pos] = k[:, 0]
            cache["v"][:, write_pos] = v[:, 0]
            attn = decode_attention(q, cache["k"], cache["v"], write_pos + 1,
                                    window=cfg.sliding_window)
            y = attention_output(blk.attn, attn)
        x = blk.ffn(x + y, cfg.norm_eps)
    return model.logits(x), caches, cache_len + 1
