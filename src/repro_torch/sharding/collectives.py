"""Collectives of a per-device body: on a mesh, or formed in one process.

A body that runs on one device of a mesh (the MoE layer's,
:func:`repro_torch.models.moe.moe_device_body`, and the context-parallel
decode softmax's, :func:`repro_torch.models.attention.decode_device_body`)
is a generator over plain tensors: it yields each collective it needs as a
:class:`Collective` and is sent the result. Its return value is the
body's result. Two functions run it:

* :func:`on_mesh` on this rank of a ``DeviceMesh`` (inside ``local_map``),
  through ``torch.ops._c10d_functional``'s collectives, the ops
  :class:`~repro_torch.launch.op_analysis.OpCounter` counts, with their
  gradients;
* :func:`rank_by_rank` runs one body per rank of a layout in this process,
  stepping them together and forming each collective's result from every
  rank's input, so a test (or one card) runs a mesh's bodies without a
  process group.

A collective names *groups*, the body's own names for sets of mesh dims
("batch", "experts", ...). A group's ranks are ordered major first, the
order in which ``Shard`` over several mesh dims lays out its pieces. Every
kind works along dim 0:

* ``gather``: all-gather. Backward: the gradient is first summed over the
  ``grad_sum`` groups; then with ``grad="sum"`` it is reduce-scattered over
  the group (each rank used the gathered tensor for a part of the result),
  with ``grad="slice"`` this rank's piece is taken (every rank used it
  alike);
* ``all_to_all``: piece r of the input goes to rank r, and piece s of the
  output comes from rank s; it is its own adjoint;
* ``reduce``: all-reduce by ``op`` ("sum" or "max"); every rank uses the
  result alike, so the gradient passes through;
* ``sum_grads``: the identity; its backward sums the gradient over the
  group (each rank used the input for a part of the result).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Dict, Generator, List, Sequence, Tuple, Union

import torch

Names = Tuple[str, ...]


@dataclass
class Collective:
    kind: str                            # gather | all_to_all | reduce | sum_grads
    tensor: torch.Tensor
    group: Names
    op: str = "sum"                      # reduce: sum | max
    grad: str = "slice"                  # gather's backward: slice | sum
    grad_sum: Names = ()                 # gather's backward: groups summed first


def _names(group: Union[str, Sequence[str]]) -> Names:
    return (group,) if isinstance(group, str) else tuple(group)


def gather(t: torch.Tensor, group, grad: str = "slice", grad_sum=()) -> Collective:
    return Collective("gather", t, _names(group), grad=grad, grad_sum=_names(grad_sum))


def all_to_all(t: torch.Tensor, group) -> Collective:
    return Collective("all_to_all", t, _names(group))


def reduce(t: torch.Tensor, group, op: str = "sum") -> Collective:
    return Collective("reduce", t, _names(group), op=op)


def sum_grads(t: torch.Tensor, group) -> Collective:
    return Collective("sum_grads", t, _names(group))


Body = Generator[Collective, torch.Tensor, object]


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------

Dim = Tuple[str, int]                    # (process group name, size) of one mesh dim


def _wait(t: torch.Tensor) -> torch.Tensor:
    return torch.ops._c10d_functional.wait_tensor(t)


def _all_gather(t: torch.Tensor, dims: Sequence[Dim]) -> torch.Tensor:
    for name, n in reversed(dims):       # minor first: the pieces end up major first
        t = _wait(torch.ops._c10d_functional.all_gather_into_tensor(t.contiguous(), n, name))
    return t


def _reduce_scatter(t: torch.Tensor, dims: Sequence[Dim]) -> torch.Tensor:
    for name, n in dims:                 # major first
        t = _wait(torch.ops._c10d_functional.reduce_scatter_tensor(t.contiguous(), "sum", n,
                                                                   name))
    return t


def _all_reduce(t: torch.Tensor, dims: Sequence[Dim], op: str) -> torch.Tensor:
    for name, _ in dims:
        t = _wait(torch.ops._c10d_functional.all_reduce(t.contiguous(), op, name))
    return t


def _all_to_all(t: torch.Tensor, dims: Sequence[Dim]) -> torch.Tensor:
    """Over several mesh dims: over the major one, then the rest on the
    transposed pieces, so piece r goes to the group's rank r."""
    if not dims:
        return t
    (name, n), rest = dims[0], dims[1:]
    m = t.shape[0] // n
    t = _wait(torch.ops._c10d_functional.all_to_all_single(t.contiguous(), [m] * n, [m] * n,
                                                           name))
    if not rest:
        return t
    r = 1
    for _, size in rest:
        r *= size
    t = t.reshape(n, r, m // r, *t.shape[1:]).transpose(0, 1).reshape(t.shape)
    t = _all_to_all(t, rest)
    return t.reshape(r, n, m // r, *t.shape[1:]).transpose(0, 1).reshape(t.shape)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dims, grad, grad_dims, index):
        ctx.dims, ctx.grad, ctx.grad_dims, ctx.index = dims, grad, grad_dims, index
        return _all_gather(t, dims)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.grad_dims, "sum")
        if ctx.grad == "sum":
            g = _reduce_scatter(g, ctx.dims)
        else:
            n = 1
            for _, size in ctx.dims:
                n *= size
            g = g.chunk(n)[ctx.index].contiguous()
        return g, None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dims):
        ctx.dims = dims
        return _all_to_all(t, dims)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.dims), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dims, op):
        return _all_reduce(t, dims, op)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dims):
        ctx.dims = dims
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.dims, "sum"), None


def flat_rank(mesh, dims: Sequence[int]) -> int:
    """This rank's index in the group of mesh dims ``dims``, major first."""
    i = 0
    for d in dims:
        i = i * mesh.size(d) + mesh.get_local_rank(d)
    return i


def on_mesh(body: Body, mesh, groups: Dict[str, Sequence[int]]):
    """Runs ``body`` on this rank of ``mesh``; ``groups`` maps each group
    name to its mesh dims, major first. Returns the body's result."""
    def dims(names: Names) -> List[Dim]:
        return [(mesh.get_group(d).group_name, mesh.size(d)) for n in names for d in groups[n]]

    def perform(c: Collective) -> torch.Tensor:
        d = dims(c.group)
        if c.kind == "gather":
            return _Gather.apply(c.tensor, d, c.grad, dims(c.grad_sum),
                                 flat_rank(mesh, [i for n in c.group for i in groups[n]]))
        if c.kind == "all_to_all":
            return _AllToAll.apply(c.tensor, d)
        if c.kind == "reduce":
            return _Reduce.apply(c.tensor, d, c.op)
        if c.kind == "sum_grads":
            return _SumGrads.apply(c.tensor, d)
        raise ValueError(f"unknown collective {c.kind!r}")
    return _drive(body, perform)


def summing_grads(t: torch.Tensor, mesh, dims: Sequence[int]) -> torch.Tensor:
    """``t`` itself, its gradient summed over the mesh dims ``dims`` in the
    backward: for a tensor that every rank of those dims holds whole but
    uses for a part of the result (inside ``local_map``)."""
    if not dims:
        return t
    return _SumGrads.apply(t, [(mesh.get_group(d).group_name, mesh.size(d)) for d in dims])


def _drive(body: Body, perform: Callable[[Collective], torch.Tensor]):
    try:
        request = next(body)
        while True:
            request = body.send(perform(request))
    except StopIteration as stop:
        return stop.value


# ---------------------------------------------------------------------------
# rank by rank, in one process
# ---------------------------------------------------------------------------

def rank_by_rank(make_body: Callable[[Dict[str, int]], Body], sizes: Dict[str, int]) -> Dict:
    """Runs ``make_body(coords)`` for every rank of a layout whose groups have
    ``sizes`` (name → ranks), all bodies a step at a time; each collective's
    result is formed from the inputs of the ranks of its group. Returns
    {coordinates (a tuple in ``sizes``' order): the body's result}."""
    names = list(sizes)
    ranks = list(itertools.product(*(range(sizes[n]) for n in names)))
    bodies = {r: make_body(dict(zip(names, r))) for r in ranks}
    results: Dict = {}
    requests: Dict = {}
    for r, b in bodies.items():
        try:
            requests[r] = next(b)
        except StopIteration as stop:
            results[r] = stop.value
    while requests:
        if len(requests) != len(ranks):
            raise RuntimeError("the ranks' bodies yield different numbers of collectives")
        kinds = {(c.kind, c.group, c.op) for c in requests.values()}
        if len(kinds) != 1:
            raise RuntimeError(f"the ranks' bodies disagree on a collective: {sorted(kinds)}")
        replies = {r: _form(r, requests, names) for r in ranks}
        requests = {}
        for r, b in bodies.items():
            try:
                requests[r] = b.send(replies[r])
            except StopIteration as stop:
                results[r] = stop.value
    return results


def _form(rank: Tuple[int, ...], requests: Dict, names: List[str]) -> torch.Tensor:
    """Rank ``rank``'s result of the collective every rank has requested."""
    c = requests[rank]
    axes = [names.index(n) for n in c.group]
    members = sorted((r for r in requests
                      if all(r[i] == rank[i] for i in range(len(names)) if i not in axes)),
                     key=lambda r: tuple(r[i] for i in axes))
    pieces = [requests[m].tensor for m in members]
    if c.kind == "sum_grads":
        return c.tensor
    if c.kind == "gather":
        return torch.cat(pieces)
    if c.kind == "all_to_all":
        me = members.index(rank)
        return torch.cat([p.chunk(len(members))[me] for p in pieces])
    out = pieces[0]
    for p in pieces[1:]:
        out = out + p if c.op == "sum" else torch.maximum(out, p)
    return out
