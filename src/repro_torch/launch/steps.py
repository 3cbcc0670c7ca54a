"""The mesh steps: train_step / prefill_step / decode_step (port of
``repro.launch.steps``).

Each ``make_*`` returns (step, args) as the reference does: the step for a
config on a mesh, and its arguments as meta tensors (the reference's
``ShapeDtypeStruct``\\ s). On a mesh of more than one device the meta
arguments are ``DTensor``\\ s with the placements of the reference's
sharding trees (``param_shardings``, ``opt_state_shardings``,
``cache_shardings``, the batch over the data axes), and the step pins its
activations through :mod:`repro_torch.sharding.context`; the dry run
(:mod:`repro_torch.launch.dryrun`) runs it so, on the meta device, over a
fake process group. On the 1×1 mesh every placement is trivial and every
tensor local: the step is the port's own :func:`train_step`,
:func:`forward_prefill` and :func:`forward_decode` on plain tensors, so on
the card K2 (forward and backward) and K3 run in it as they do there.

The step takes the port's objects where the reference takes pytrees: a
:class:`~repro_torch.models.transformer.Transformer` for the parameters,
the optimizer's ``OptState``, the caches as :func:`init_cache` lays them
out. A train step updates the model and the state in place and returns
them, as the reference's donated buffers come back. A step given real
tensors on a mesh whose ranks are not there (the fake group) raises: such
a mesh is for the dry run only.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..models.config import ModelConfig
from ..models.convert import Leaf, flatten, param_leaves, param_tree
from ..models.transformer import (
    Transformer,
    forward_decode,
    forward_prefill,
    init_tensors,
    model_tensors,
    params_spec,
)
from ..sharding.context import activation_sharding, constrain_axes
from ..sharding.rules import (
    P,
    NamedSharding,
    batch_spec,
    cache_spec,
    local_shape,
    map_tree,
    mesh_shape,
    placements,
    spec_for_shape,
    tree_shardings,
)
from ..train.loop import cross_entropy_loss, train_step as _train_step
from ..train.optimizer import OptState, make_optimizer
from .shapes import InputShape, config_for_shape, input_specs


# ---------------------------------------------------------------------------
# parameters and their shardings
# ---------------------------------------------------------------------------

def _to_meta(tree: Any) -> Any:
    return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def param_tensors(cfg: ModelConfig) -> Dict:
    """:func:`init_tensors`' tree on the meta device: shapes and dtypes only
    (drawn under a fake-tensor mode, so nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init_tensors(cfg, device="cpu")
    return _to_meta(fake)


def param_shapes(cfg: ModelConfig) -> Transformer:
    """The model on the meta device."""
    return Transformer(cfg, param_tensors(cfg))


def _unstacked(spec: Any) -> Any:
    """A stacked spec tree's per-layer axes: the leading ``layers`` dropped."""
    return map_tree(lambda axes: tuple(axes)[1:], spec)


def _per_layer_specs(cfg: ModelConfig) -> Dict:
    """Logical axes in the tree of :func:`init_tensors` (one dict per layer)."""
    spec = params_spec(cfg)
    period = len(cfg.layout_pattern)
    out = {k: spec[k] for k in ("embed", "final_norm", "head") if k in spec}
    out["blocks"] = [_unstacked(spec["blocks"][layer % period])
                     for layer in range(cfg.num_layers)]
    if cfg.is_encoder_decoder:
        out["encoder"] = {"blocks": [_unstacked(spec["encoder"]["blocks"])]
                          * cfg.encoder_layers,
                          "final_norm": spec["encoder"]["final_norm"]}
    return out


def param_shardings(cfg: ModelConfig, mesh: Any) -> Any:
    """NamedShardings in the reference's tree (stacked leaves)."""
    leaf_shapes = map_tree(lambda leaf: leaf.shape, param_tree(param_shapes(cfg)))
    return tree_shardings(params_spec(cfg), leaf_shapes, mesh)


def opt_state_shardings(state: OptState, model: Transformer, mesh: Any) -> List[NamedSharding]:
    """Optimizer-state shardings, in the state's flatten order: a leaf of a
    parameter's (stacked) shape takes that parameter's sharding; factored
    (vr/vc) and scalar leaves are replicated."""
    cfg = model.cfg
    by_shape: Dict = {}
    for leaf, sh in zip(param_leaves(model), flatten(param_shardings(cfg, mesh))):
        by_shape.setdefault(tuple(leaf.shape), sh)
    repl = NamedSharding(mesh, P())
    return [by_shape.get(tuple(t.shape), repl) for t in flatten(state)]


# ---------------------------------------------------------------------------
# meta DTensors
# ---------------------------------------------------------------------------

def _mesh_size(mesh: Any) -> int:
    n = 1
    for v in mesh_shape(mesh).values():
        n *= v
    return n


def meta_dtensor(t: torch.Tensor, mesh: Any, spec) -> torch.Tensor:
    """``t``'s shape and dtype as a meta ``DTensor`` placed by ``spec``."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(local_shape(mesh, spec, t.shape), dtype=t.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements(mesh, spec), run_check=False,
                              shape=t.shape, stride=torch.empty(t.shape, device="meta").stride())


def _placed_model(cfg: ModelConfig, mesh: Any) -> Transformer:
    """The meta model, every tensor a DTensor placed by the sharding rules."""
    tensors = param_tensors(cfg)
    if _mesh_size(mesh) == 1:
        return Transformer(cfg, tensors)

    def place(t, axes):
        return meta_dtensor(t, mesh, spec_for_shape(tuple(axes), t.shape, mesh))
    return Transformer(cfg, map_tree(place, tensors, _per_layer_specs(cfg)))


def shard_tensor(t: torch.Tensor, mesh: Any, spec) -> torch.Tensor:
    """``t``, which every rank of ``mesh`` holds whole, as a ``DTensor``
    placed by ``spec``: each rank keeps its shard (no collective)."""
    from torch.distributed.tensor import DTensor
    pl = placements(mesh, spec)
    local = t.detach()
    for i, p in enumerate(pl):
        if p.is_shard():
            local = local.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_model(model: Transformer, mesh: Any) -> Transformer:
    """``model`` on a mesh of ranks that are present (every rank holding
    the same weights): every tensor a ``DTensor`` placed by the sharding
    rules (:func:`shard_tensor`). On a 1×1 mesh the model itself."""
    if _mesh_size(mesh) == 1:
        return model

    def place(t, axes):
        return shard_tensor(t, mesh, spec_for_shape(tuple(axes), t.shape, mesh))
    return Transformer(model.cfg, map_tree(place, model_tensors(model),
                                           _per_layer_specs(model.cfg)))


def _place_state(state: OptState, model: Transformer, mesh: Any) -> OptState:
    """The optimizer state as DTensors: a plain tensor takes
    :func:`opt_state_shardings`' placement (AdamW's moments, made
    ``zeros_like`` the parameters, are DTensors already)."""
    from torch.distributed.tensor import DTensor
    shardings = iter(opt_state_shardings(state, model, mesh))

    def place(t):
        sh = next(shardings)
        if isinstance(t, Leaf):
            return Leaf([x if isinstance(x, DTensor) else meta_dtensor(x, mesh, P())
                         for x in t.tensors], t.stacked)
        return t if isinstance(t, DTensor) else meta_dtensor(t, mesh, sh.spec)
    return OptState(step=place(state.step), inner=_map_state(place, state.inner))


def _map_state(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_state(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_state(fn, t) for t in tree)
    return fn(tree)


def _data(t: torch.Tensor, mesh: Any, batch: int) -> torch.Tensor:
    """An input with its batch dim over the data axes (plain on a 1×1 mesh)."""
    if _mesh_size(mesh) == 1:
        return t
    return meta_dtensor(t, mesh, batch_spec(mesh, batch))


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _dp_axes(mesh: Any, batch: int):
    spec = batch_spec(mesh, batch)
    return spec[0] if len(spec) else None


def _batch_axes_tuple(mesh: Any, batch: int):
    dp = _dp_axes(mesh, batch)
    if dp is None or _mesh_size(mesh) == 1:
        return None
    return tuple(dp) if isinstance(dp, (tuple, list)) else (dp,)


def _vocab_axis(cfg: ModelConfig, mesh: Any):
    """'model' when the vocab divides the axis (mamba2's 50280 and
    whisper's 51865 do not divide 16: those logits replicate)."""
    return "model" if cfg.vocab_size % mesh_shape(mesh).get("model", 1) == 0 else None


def _on_mesh(mesh: Any, batch_axes):
    """The context a step runs in: its activation sharding and, on a mesh
    of more than one device, plain tensors the model makes (positions,
    masks) taken as replicated."""
    stack = contextlib.ExitStack()
    stack.enter_context(activation_sharding(batch_axes))
    if _mesh_size(mesh) > 1:
        from torch.distributed.tensor.experimental import implicit_replication
        stack.enter_context(implicit_replication())
    return stack


def _runnable(mesh: Any, *tensors: Optional[torch.Tensor]) -> None:
    """Raises for real tensors on a mesh whose ranks are not there."""
    import torch.distributed as dist
    if _mesh_size(mesh) == 1 or all(t is None or t.device.type == "meta" for t in tensors):
        return
    if dist.is_initialized() and dist.get_backend() != "fake":
        return
    raise RuntimeError(f"a mesh of {_mesh_size(mesh)} devices ({mesh_shape(mesh)}) is for "
                       f"the dry run only: its ranks are not present; run the step on "
                       f"meta tensors, or on make_host_mesh()")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's vocab-sharding-friendly loss on a ``DTensor``: a
    one-hot contraction in place of a gather, so a model-sharded vocab stays
    a partial sum and a small all-reduce. On a plain tensor (the 1×1 mesh,
    where no vocab is sharded) the same mean through the gather of
    :func:`~repro_torch.train.loop.cross_entropy_loss`, which makes no
    (tokens × vocab) one-hot: 3.3 GB in f32 at phi4-mini-3.8b's vocab of
    200,064 for 4 × 1024 tokens."""
    from torch.distributed.tensor import DTensor
    if not isinstance(logits, DTensor):
        return cross_entropy_loss(logits, labels.long())
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).float()
    tgt = torch.einsum("bsv,bsv->bs", logits32, onehot)
    return torch.mean(lse - tgt)


def make_train_step(cfg: ModelConfig, mesh: Any, shape: InputShape, optimizer: str = "adamw",
                    lr: Optional[float] = None):
    """Returns (step, args): ``step(model, opt_state, tokens, labels[,
    cross_src]) -> (model, opt_state, loss)``, remat on, and its arguments
    on the meta device. ``lr`` is the optimizer's rate (its default when
    None, as the reference's step takes it)."""
    cfg = config_for_shape(cfg, shape)
    opt = make_optimizer(optimizer, lr=lr)
    ba = _batch_axes_tuple(mesh, shape.global_batch)
    va = _vocab_axis(cfg, mesh)

    def loss_fn(logits, labels):
        return cross_entropy(constrain_axes(logits, None, va), labels)

    def train_step(model, opt_state, tokens, labels, cross_src=None):
        _runnable(mesh, tokens, labels, cross_src)
        with _on_mesh(mesh, ba):
            opt_state, loss = _train_step(model, opt, opt_state, tokens, labels, cross_src,
                                          remat=True, loss_fn=loss_fn)
        return model, opt_state, loss

    model = _placed_model(cfg, mesh)
    model.requires_grad_(True)
    state = opt[0](param_leaves(model))
    if _mesh_size(mesh) > 1:
        state = _place_state(state, model, mesh)
    specs = input_specs(cfg, shape)
    b = shape.global_batch
    args = [model, state, _data(specs["tokens"], mesh, b), _data(specs["labels"], mesh, b)]
    if "cross_src" in specs:
        args.append(_data(specs["cross_src"], mesh, b))
    return train_step, tuple(args)


def make_prefill_step(cfg: ModelConfig, mesh: Any, shape: InputShape):
    """Returns (step, args): ``step(model, tokens[, cross_src]) ->
    (last-token logits, caches, cache_len)``, caches of ``seq_len`` slots."""
    cfg = config_for_shape(cfg, shape)
    ba = _batch_axes_tuple(mesh, shape.global_batch)

    def prefill_step(model, tokens, cross_src=None):
        _runnable(mesh, tokens, cross_src)
        with _on_mesh(mesh, ba), torch.no_grad():
            return forward_prefill(model, tokens, shape.seq_len, cross_src)

    specs = input_specs(cfg, shape)
    b = shape.global_batch
    args = [_placed_model(cfg, mesh), _data(specs["tokens"], mesh, b)]
    if "cross_src" in specs:
        args.append(_data(specs["cross_src"], mesh, b))
    return prefill_step, tuple(args)


def make_decode_step(cfg: ModelConfig, mesh: Any, shape: InputShape):
    """The serve step: ONE token against a ``seq_len`` cache. Returns
    (step, args): ``step(model, token, caches, cache_len) -> (logits,
    caches, cache_len + 1)``, the caches updated in place. ``cache_len`` is
    an int; the args take ``seq_len - 1``, the cache full but for the new
    token."""
    cfg = config_for_shape(cfg, shape)
    ba = _batch_axes_tuple(mesh, shape.global_batch)
    va = _vocab_axis(cfg, mesh)

    def decode_step(model, token, caches, cache_len):
        _runnable(mesh, token)
        with _on_mesh(mesh, ba), torch.no_grad():
            logits, caches, n = forward_decode(model, token, caches, int(cache_len))
            return constrain_axes(logits, None, va), caches, n

    specs = input_specs(cfg, shape)
    caches = specs["caches"]
    if _mesh_size(mesh) > 1:
        caches = [{k: meta_dtensor(t, mesh, cache_spec(cfg, mesh, k, tuple(t.shape)))
                   for k, t in c.items()} for c in caches]
    args = (_placed_model(cfg, mesh), _data(specs["token"], mesh, shape.global_batch),
            caches, shape.seq_len - 1)
    return decode_step, args


def make_step(cfg: ModelConfig, mesh: Any, shape: InputShape, optimizer: str = "adamw"):
    """Dispatch by shape kind; returns (step, args)."""
    if shape.kind == "train":
        return make_train_step(cfg, mesh, shape, optimizer)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape)
    return make_decode_step(cfg, mesh, shape)
