"""Model assembly: every block kind of the reference, and the
encoder-decoder stack.

Port of ``repro.models.transformer``. The reference stacks parameters over
pattern repetitions and scans; PyTorch runs eagerly, so the port keeps one
:class:`Block` per layer in an ``nn.ModuleList`` (layer ``r·|pattern| + j``
is repetition ``r`` of pattern position ``j``). A block is a mixer (self-
attention for ``attn``/``attn_moe``, gated cross-attention for ``cross``, a
Mamba2 mixer for ``ssm``/``ssm_mlp``/``ssm_moe``), then a dense SwiGLU
(``attn``, ``cross``, ``ssm_mlp``, where ``d_ff``) or an MoE FFN
(``*_moe``). Every decoder layer of an encoder-decoder model (whisper) also
cross-attends to the encoder's output after its self-attention.

Entry points, as in the reference:
* :func:`forward_train` — full-sequence logits (training / loss), with
  remat over each pattern repetition;
* :func:`encode` — the encoder stack over stub frame embeddings;
* :func:`forward_prefill` — last-token logits + populated caches;
* :func:`forward_decode` — one token against the caches (serve step).

Parameters are built frozen, for serving; training makes them trainable
(``model.requires_grad_(True)``, as ``repro_torch.train.train`` does).

Caches are one dict per layer: ``{"k", "v"}`` (B, S, Kv, hd) for
self-attention, holding post-RoPE keys; ``{"ck", "cv"}`` (B, T, Kv, hd) for
a layer that cross-attends, the keys and values of the encoder output or
image embeddings (without ``k_norm``, as the reference caches them); and
``{"conv": (B, w-1, d_inner+2GN) in the model dtype, "state": (B, H, P, N)
f32}`` for the Mamba2 kinds. Unlike the reference's functional updates,
the port preallocates them (k/v at the serving capacity) and updates them
in place at every decoded token.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..sharding.context import constrain_batch, matmul
from .attention import (
    _proj,
    attention_output,
    blockwise_attention,
    cross_attention,
    decode_attention,
    project_qkv,
    write_slot,
)
from .config import ATTN, ATTN_MOE, CROSS, SSM_MLP, ModelConfig
from .layers import (
    attention_spec,
    dense_init,
    init_attention,
    init_mlp,
    mlp_spec,
    rms_norm,
    swiglu,
)
from .moe import init_moe, moe_ffn, moe_spec
from .ssm import init_mamba2, mamba2_decode_step, mamba2_mixer, mamba2_spec

Cache = Dict[str, torch.Tensor]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _kind_has_self_attn(kind: str) -> bool:
    return kind in (ATTN, ATTN_MOE)


def _kind_has_ssm(kind: str) -> bool:
    return kind.startswith("ssm")


def _kind_ffn(kind: str, cfg: ModelConfig) -> str:
    """'moe' | 'dense' | 'none' for the FFN half of the block."""
    if kind.endswith("moe"):
        return "moe"
    if kind in (ATTN, CROSS, SSM_MLP):
        return "dense" if cfg.d_ff else "none"
    return "none"


def check_supported(cfg: ModelConfig) -> None:
    """Every valid config runs; raises ``ValueError`` for an invalid one."""
    cfg.validate()


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _frozen_dict(tensors: Dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in tensors.items()})


def _cross_kv(params: nn.ParameterDict, src: torch.Tensor,
              cache: Optional[Cache]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys and values of ``src`` for cross-attention, written to the cache."""
    ck, cv = _proj(src, params["wk"]), _proj(src, params["wv"])
    if cache is not None:
        cache["ck"].copy_(ck)
        cache["cv"].copy_(cv)
    return ck, cv


class Block(nn.Module):
    """One layer: a pre-norm mixer, then a pre-norm FFN where it has one."""

    def __init__(self, kind: str, tensors: Dict) -> None:
        super().__init__()
        self.kind = kind

        def frozen(name):
            return _frozen(tensors[name]) if name in tensors else None

        def frozen_dict(name):
            return _frozen_dict(tensors[name]) if name in tensors else None
        self.ln1 = frozen("ln1")
        self.attn = frozen_dict("attn")          # attn, attn_moe
        self.xattn = frozen_dict("xattn")        # cross
        self.ssm = frozen_dict("ssm")            # ssm, ssm_mlp, ssm_moe
        self.ln_cross = frozen("ln_cross")       # decoder layers of an encoder-decoder
        self.cross = frozen_dict("cross")
        self.ln2 = frozen("ln2")
        self.mlp = frozen_dict("mlp")
        self.moe = frozen_dict("moe")

    def ffn(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        if self.mlp is not None:
            h = rms_norm(x, self.ln2, cfg.norm_eps)
            return x + swiglu(h, self.mlp["w_gate"], self.mlp["w_up"], self.mlp["w_down"])
        if self.moe is not None:
            h = rms_norm(x, self.ln2, cfg.norm_eps)
            return x + moe_ffn(self.moe, h, cfg.num_experts, cfg.experts_per_token,
                               cfg.capacity_factor)
        return x

    def prefill(self, x: torch.Tensor, pos: torch.Tensor, cross_src: Optional[torch.Tensor],
                cfg: ModelConfig, cache: Optional[Cache] = None,
                causal: bool = True) -> torch.Tensor:
        """Full-sequence pass (the reference's ``block_forward_full``): for
        training without a cache, for prefill filling ``cache``."""
        eps = cfg.norm_eps
        h = rms_norm(x, self.ln1, eps)
        if self.attn is not None:
            q, k, v = project_qkv(self.attn, h, pos, cfg.rope_theta, cfg.qk_norm,
                                  use_rope=True, norm_eps=eps)
            attn = blockwise_attention(q, k, v, causal=causal, window=cfg.sliding_window)
            x = x + attention_output(self.attn, attn)
            if cache is not None:
                cache["k"][:, :x.shape[1]] = k
                cache["v"][:, :x.shape[1]] = v
            if self.cross is not None and cross_src is not None:
                hc = rms_norm(x, self.ln_cross, eps)
                kv = _cross_kv(self.cross, cross_src, cache)
                x = x + cross_attention(self.cross, hc, cross_src, eps, kv=kv)
        elif self.xattn is not None:
            kv = _cross_kv(self.xattn, cross_src, cache)
            x = x + cross_attention(self.xattn, h, cross_src, eps, qk_norm=cfg.qk_norm, kv=kv)
        else:
            y, (conv, state) = mamba2_mixer(self.ssm, h, cfg, return_state=True)
            if cache is not None:
                cache["conv"].copy_(conv)
                cache["state"].copy_(state)
            x = x + y
        return self.ffn(x, cfg)

    def decode(self, x: torch.Tensor, pos: torch.Tensor, cache: Cache, cache_len: int,
               cfg: ModelConfig) -> torch.Tensor:
        """One token (B, 1, D) against ``cache``, updated in place."""
        eps = cfg.norm_eps
        h = rms_norm(x, self.ln1, eps)
        if self.attn is not None:
            slots = cache["k"].shape[1]
            write_pos = cache_len % slots if cfg.sliding_window else cache_len
            if write_pos >= slots:
                raise ValueError(f"cache full: {slots} slots, writing position {write_pos}")
            q, k, v = project_qkv(self.attn, h, pos, cfg.rope_theta, cfg.qk_norm,
                                  use_rope=True, norm_eps=eps)
            write_slot(cache["k"], write_pos, k[:, 0])
            write_slot(cache["v"], write_pos, v[:, 0])
            attn = decode_attention(q, cache["k"], cache["v"], write_pos + 1,
                                    window=cfg.sliding_window)
            x = x + attention_output(self.attn, attn)
            if self.cross is not None:
                hc = rms_norm(x, self.ln_cross, eps)
                qc = _proj(hc, self.cross["wq"])
                a = decode_attention(qc, cache["ck"], cache["cv"], cache["ck"].shape[1])
                x = x + attention_output(self.cross, a)
        elif self.xattn is not None:
            qc = _proj(h, self.xattn["wq"])
            if cfg.qk_norm:          # the cached keys carry no k_norm (reference)
                qc = rms_norm(qc, self.xattn["q_norm"], eps)
            a = decode_attention(qc, cache["ck"], cache["cv"], cache["ck"].shape[1])
            y = attention_output(self.xattn, a)
            if "attn_gate" in self.xattn:
                y = torch.tanh(self.xattn["attn_gate"]) * y
            x = x + y
        else:
            y, (conv, state) = mamba2_decode_step(self.ssm, h, cfg, cache["conv"],
                                                  cache["state"])
            cache["conv"].copy_(conv)
            cache["state"].copy_(state)
            x = x + y
        return self.ffn(x, cfg)


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Block kind of every layer: the pattern, repeated."""
    pattern = cfg.layout_pattern
    return [pattern[layer % len(pattern)] for layer in range(cfg.num_layers)]


class Encoder(nn.Module):
    """The encoder of an encoder-decoder model: ``attn`` blocks, final norm."""

    def __init__(self, tensors: Dict) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(Block(ATTN, t) for t in tensors["blocks"])
        self.final_norm = _frozen(tensors["final_norm"])


class Transformer(nn.Module):
    """Weights of a model, in the reference's layouts."""

    def __init__(self, cfg: ModelConfig, tensors: Dict) -> None:
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _frozen(tensors["embed"])                 # (V, D)
        self.final_norm = _frozen(tensors["final_norm"])
        self.head = None if cfg.tie_embeddings else _frozen(tensors["head"])   # (D, V)
        if len(tensors["blocks"]) != cfg.num_layers:
            raise ValueError(f"{len(tensors['blocks'])} blocks for {cfg.num_layers} layers")
        self.blocks = nn.ModuleList(
            Block(kind, t) for kind, t in zip(layer_kinds(cfg), tensors["blocks"]))
        self.encoder = None
        if cfg.is_encoder_decoder:
            if len(tensors["encoder"]["blocks"]) != cfg.encoder_layers:
                raise ValueError(f"{len(tensors['encoder']['blocks'])} encoder blocks for "
                                 f"{cfg.encoder_layers} layers")
            self.encoder = Encoder(tensors["encoder"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.head is None else self.head
        return matmul(x, head)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig,
                with_cross: bool = False) -> Dict:
    dt, dev = _dtype(cfg), gen.device
    hd = cfg.resolved_head_dim

    def ones():
        return torch.ones((cfg.d_model,), dtype=dt, device=dev)
    blk: Dict = {"ln1": ones()}
    if _kind_has_self_attn(kind):
        blk["attn"] = init_attention(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, hd,
                                     qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, dtype=dt)
    if kind == CROSS:
        blk["xattn"] = init_attention(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, hd,
                                      qk_norm=cfg.qk_norm, gated=True, dtype=dt)
    if _kind_has_ssm(kind):
        blk["ssm"] = init_mamba2(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                                 cfg.ssm_groups, cfg.ssm_conv_width, dtype=dt)
    if with_cross and _kind_has_self_attn(kind):
        blk["ln_cross"] = ones()
        blk["cross"] = init_attention(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, hd,
                                      dtype=dt)
    ffn = _kind_ffn(kind, cfg)
    if ffn != "none":
        blk["ln2"] = ones()
    if ffn == "dense":
        blk["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dt)
    elif ffn == "moe":
        blk["moe"] = init_moe(gen, cfg.d_model, cfg.num_experts, cfg.moe_d_ff, dtype=dt)
    return blk


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[torch.device | str] = None) -> Transformer:
    """Random weights with the reference's distributions, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``."""
    return Transformer(cfg, init_tensors(cfg, seed, device))


def init_tensors(cfg: ModelConfig, seed: int = 0,
                 device: Optional[torch.device | str] = None) -> Dict:
    """:func:`init_params`' tensors, in the tree :class:`Transformer` takes."""
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
    tensors["blocks"] = [_init_block(gen, kind, cfg, with_cross=cfg.is_encoder_decoder)
                         for kind in layer_kinds(cfg)]
    if cfg.is_encoder_decoder:
        tensors["encoder"] = {
            "blocks": [_init_block(gen, ATTN, cfg) for _ in range(cfg.encoder_layers)],
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        }
    return tensors


_BLOCK_PARTS = ("ln1", "attn", "xattn", "ssm", "ln_cross", "cross", "ln2", "mlp", "moe")


def model_tensors(model: Transformer) -> Dict:
    """The model's own tensors (not copies) in the tree :func:`init_tensors`
    gives and :class:`Transformer` takes."""
    def block(blk: Block) -> Dict:
        out: Dict = {}
        for name in _BLOCK_PARTS:
            part = getattr(blk, name)
            if part is not None:
                out[name] = (dict(part.items()) if isinstance(part, nn.ParameterDict)
                             else part)
        return out
    tensors: Dict = {"embed": model.embed, "final_norm": model.final_norm,
                     "blocks": [block(b) for b in model.blocks]}
    if model.head is not None:
        tensors["head"] = model.head
    if model.encoder is not None:
        tensors["encoder"] = {"blocks": [block(b) for b in model.encoder.blocks],
                              "final_norm": model.encoder.final_norm}
    return tensors


def block_spec(kind: str, cfg: ModelConfig, with_cross: bool = False) -> Dict:
    """Logical axes of one block's tensors, by kind (``repro.sharding.rules``'s names)."""
    p: Dict = {"ln1": ("embed",)}
    if _kind_has_self_attn(kind):
        p["attn"] = attention_spec(cfg.qkv_bias, cfg.qk_norm)
    if kind == CROSS:
        p["xattn"] = attention_spec(False, cfg.qk_norm, gated=True)
    if _kind_has_ssm(kind):
        p["ssm"] = mamba2_spec()
    if with_cross and _kind_has_self_attn(kind):
        p["ln_cross"] = ("embed",)
        p["cross"] = attention_spec()
    ffn = _kind_ffn(kind, cfg)
    if ffn != "none":
        p["ln2"] = ("embed",)
    if ffn == "dense":
        p["mlp"] = mlp_spec()
    elif ffn == "moe":
        p["moe"] = moe_spec()
    return p


def params_spec(cfg: ModelConfig) -> Dict:
    """Logical axes of every parameter, in the reference's tree: ``blocks``
    a tuple over pattern positions with a leading ``layers`` axis on every
    leaf, the layout :func:`~repro_torch.models.convert.param_tree` gives the
    port's tensors in."""
    spec: Dict = {"embed": ("vocab", "embed"), "final_norm": ("embed",)}
    if not cfg.tie_embeddings:
        spec["head"] = ("embed", "vocab")

    def stack(tree):
        return {k: stack(v) if isinstance(v, dict) else ("layers",) + tuple(v)
                for k, v in tree.items()}
    spec["blocks"] = tuple(
        stack(block_spec(kind, cfg, with_cross=cfg.is_encoder_decoder))
        for kind in cfg.layout_pattern)
    if cfg.is_encoder_decoder:
        spec["encoder"] = {"blocks": stack(block_spec(ATTN, cfg)), "final_norm": ("embed",)}
    return spec


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _caches(cfg: ModelConfig, batch: int, slots: int, cross_len: int, dtype: torch.dtype,
            device: torch.device, like: Optional[torch.Tensor] = None) -> List[Cache]:
    """Zeroed caches, one dict per layer, by block kind: ``slots`` k/v
    positions for self-attention, ``cross_len`` for cross-attention. With
    ``like`` they are its ``new_zeros`` (a ``DTensor``'s, on a mesh)."""
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    conv = (batch, cfg.ssm_conv_width - 1, cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
    state = (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)

    def zeros(shape, dt=dtype):
        if like is not None:
            return like.new_zeros(shape, dtype=dt)
        return torch.zeros(shape, dtype=dt, device=device)
    caches = []
    for kind in layer_kinds(cfg):
        c: Cache = {}
        if _kind_has_self_attn(kind):
            c["k"] = zeros((batch, slots, kvh, hd))
            c["v"] = zeros((batch, slots, kvh, hd))
        if kind == CROSS or (cfg.is_encoder_decoder and _kind_has_self_attn(kind)):
            c["ck"] = zeros((batch, cross_len, kvh, hd))
            c["cv"] = zeros((batch, cross_len, kvh, hd))
        if _kind_has_ssm(kind):
            c["conv"] = zeros(conv)
            c["state"] = zeros(state, torch.float32)
        caches.append(c)
    return caches


def init_cache(cfg: ModelConfig, batch: int, max_cache_len: int, cross_len: int = 0,
               dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device | str] = None) -> List[Cache]:
    """Empty serving caches for :func:`forward_decode`; sliding-window
    models keep only the window."""
    check_supported(cfg)
    slots = min(max_cache_len, cfg.sliding_window) if cfg.sliding_window else max_cache_len
    return _caches(cfg, batch, slots, cross_len, dtype or _dtype(cfg), resolve_device(device))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def encode(model: Transformer, frames: torch.Tensor) -> torch.Tensor:
    """Encoder stack over stub frame embeddings (B, T, D): bidirectional
    ``attn`` blocks with RoPE, then the encoder's final norm."""
    cfg = model.cfg
    b, t, _ = frames.shape
    pos = torch.arange(t, device=frames.device).expand(b, t)
    x = frames
    for blk in model.encoder.blocks:
        x = blk.prefill(x, pos, None, cfg, causal=False)
    return rms_norm(x, model.encoder.final_norm, cfg.norm_eps)


def _modality(model: Transformer, x: torch.Tensor,
              cross_src: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``cross_src`` in the model's dtype, through the encoder where there is one."""
    if cross_src is not None:
        cross_src = cross_src.to(x.dtype)
        if model.encoder is not None:
            cross_src = encode(model, cross_src)
    elif CROSS in model.cfg.layout_pattern:
        raise ValueError(f"{model.cfg.name}: cross blocks need cross_src")
    return cross_src


def _repetition(blocks: List[Block], cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor,
                cross_src: Optional[torch.Tensor]) -> torch.Tensor:
    x = constrain_batch(x)
    for blk in blocks:
        x = constrain_batch(blk.prefill(x, pos, cross_src, cfg))
    return x


def forward_train(model: Transformer, tokens: torch.Tensor,
                  cross_src: Optional[torch.Tensor] = None, remat: bool = True) -> torch.Tensor:
    """Full-sequence logits (B, S, V) for training: no caches.

    ``remat`` recomputes each pattern repetition's activations in the
    backward (``torch.utils.checkpoint``, non-reentrant) and keeps only its
    input, where the reference wraps its scan body in ``jax.checkpoint``.
    ``cross_src`` is cast to the model's dtype, as in :func:`forward_prefill`.
    """
    cfg = model.cfg
    b, s = tokens.shape
    x = constrain_batch(model.embed[tokens])
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    cross_src = _modality(model, x, cross_src)
    period = len(cfg.layout_pattern)
    for r in range(cfg.pattern_repeats):
        blocks = list(model.blocks[r * period:(r + 1) * period])
        if remat:
            x = checkpoint(_repetition, blocks, cfg, x, pos, cross_src, use_reentrant=False)
        else:
            x = _repetition(blocks, cfg, x, pos, cross_src)
    return model.logits(x)


def forward_prefill(model: Transformer, tokens: torch.Tensor, max_cache_len: int,
                    cross_src: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, List[Cache], int]:
    """Returns (last-token logits (B, 1, V), caches, cache_len).

    ``cross_src`` (B, T, D) is the stub modality input: image embeddings for
    ``cross`` blocks, frame embeddings for an encoder-decoder (encoded here
    first). It is cast to the model's dtype, where the reference lets an
    f32 input promote its encoder and cross K/V to f32: here they run in
    the model's dtype, so a bf16 model's K2 launches take the ``sm90``
    route and its cross caches are bf16. The k/v caches hold
    ``max(max_cache_len, S)`` slots, the prompt's post-RoPE k/v first and
    zeros after; the cross caches hold T slots; the SSM caches hold the
    conv and scan states after the prompt.
    """
    cfg = model.cfg
    b, s = tokens.shape
    x = constrain_batch(model.embed[tokens])
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    cross_src = _modality(model, x, cross_src)
    cross_len = 0 if cross_src is None else cross_src.shape[1]
    caches = _caches(cfg, b, max(max_cache_len, s), cross_len, x.dtype, x.device, like=x)
    for blk, cache in zip(model.blocks, caches):
        x = constrain_batch(blk.prefill(x, pos, cross_src, cfg, cache))
    return model.logits(x[:, -1:]), caches, s


def forward_decode(model: Transformer, token: torch.Tensor, caches: List[Cache],
                   cache_len: int) -> Tuple[torch.Tensor, List[Cache], int]:
    """One new token (B, 1) against ``caches`` (updated in place).

    Returns (logits (B, 1, V), caches, cache_len + 1).
    """
    cfg = model.cfg
    b = token.shape[0]
    x = constrain_batch(model.embed[token])
    pos = torch.full((b, 1), cache_len, dtype=torch.long, device=token.device)
    for blk, cache in zip(model.blocks, caches):
        x = constrain_batch(blk.decode(x, pos, cache, cache_len, cfg))
    return model.logits(x), caches, cache_len + 1
