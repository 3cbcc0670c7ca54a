"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Port of ``repro.models.moe``. Dispatch is *sort-based*, as in the
reference: argsort the (token, slot) assignments by expert id, gather the
tokens into an (E, C, D) buffer, run the experts as batched SwiGLU
products (:func:`expert_swiglu`, ``torch.bmm``; the reference leaves them
to XLA too), then combine. :func:`moe_ffn_dense` is the small-scale oracle.

Which kernel computes which step (on the card; CPU and meta tensors take
each kernel's plain version):

* the router (:func:`router_topk`: f32 product, softmax, top-k) and the
  plan (:func:`dispatch_plan`: stable argsort, ``searchsorted`` ranks and
  each expert's kept count) are torch ops on T·k entries;
* the route table (:func:`route_table`: each token's k destinations,
  ``expert·C + slot`` or a marker ``-1 - expert`` where dropped, beside
  its gates as ``router_topk`` returns them) is one scatter through the
  plan's order, made once a layer; both of B2's kernels read it;
* the buffer, every slot's row of x or zeros, is one launch of B2's fill
  kernel (``ops.fill_expert_slots`` → ``kernels/csrc/moe_dispatch.cu``),
  which reads each token's row once and writes it to its slots;
* the experts are cuBLAS's batched products with SiLU·up between them;
* the combine is one launch of B2's combine kernel
  (``ops.combine_expert_rows``), a warp reading a token's k routes.

Under grad the two entry points take B2's autograd Functions
(``MoeFillFn``, ``MoeCombineFn``), whose backwards are B2's adjoint
kernels over the same route table: the rows' gradient, a warp summing a
token's kept slots of the buffer's gradient; y's and the gates' gradients,
a warp a token writing ``grad_out · gate`` to each kept slot (zeros in the
empty ones) and the gate's dot with y's row. The route table holds no
gradient: the router's gradient reaches it through the gates alone. With
remat (``torch.utils.checkpoint`` over each pattern repetition) the
backward recomputes the layer from its saved input: the router's f32
product, its softmax, ``topk``, the stable argsort and the scatter of
:func:`route_table` are the same ops on the same bits, so the
recomputation rebuilds the same route table and the same buffer, and the
adjoints read the table the forward read.

What the port keeps of the reference's behaviour, on purpose:

* the capacity is ``int(max(1, round(t·k/E·cf)))`` with Python's
  ``round``; at decode with few tokens it is 1, so decode drops tokens;
* which assignments overflow follows the *stable* argsort by expert id and
  each expert's first position in the sorted order (:func:`dispatch_plan`);
* the dispatch buffer is (E, C, D) in the *weight* dtype (in the wider
  of it and x's, which differ only in ``chip_smoke.py``'s f32 witness of
  bf16 experts), equal to the reference's (E, C+1, D) buffer without its
  waste slot C, which every overflowing assignment writes and which is
  sliced away: here an overflowing assignment has no slot at all;
* the router runs in f32 on x cast to f32.

The combine is deterministic: each token's k contributions are added in
the order the reference's scatter-add applies them (by expert id), in the
activation dtype, with no atomics, so two runs on the card give the same
bits, and the kernel gives the plain version's.

**On a mesh** (x a ``DTensor``) the layer keeps the reference's global
semantics, which GSPMD keeps for its ``moe_ffn``: one capacity for the
tokens of the whole global batch, the global stable order by expert id,
the same assignments kept and dropped, the same slots. A capacity per
device would drop other tokens. The reference's docstring says the
dispatch "lowers to an all-to-all"; what GSPMD emitted for it on a 2×2
mesh was all-gathers of the router weights, the gates and the
assignments, and slabs of the activations with ``embed`` sharded
(a collective-permute and an all-reduce of (T·k, D/2)). The port's
:func:`moe_device_body` runs on every device, inside ``local_map``, over
three groups of mesh dims: *batch* (the dims x's batch is sharded over),
*experts* (the dims the expert tensors' E is sharded over: "model") and
*slots* (the rest). Per device, with T tokens in all, T_b of them its
own, n_b and n_e the groups' sizes, E_l = E / n_e, C_p the capacity
padded to a multiple of n_b·n_s, D_c = D / n_b:

1. the router on its own tokens (the router weights gathered: D·E f32);
   the assignments and gates all-gathered over *batch* (T_b·k of each),
   then every device sorts them as :func:`moe_ffn` does
   (:func:`dispatch_plan`);
2. x to ``embed``-sharded rows by an all-to-all over *batch* (T_b, D) →
   (T, D_c), the dispatch slab of its experts' slots, (E_l, C_p, D_c),
   gathered from those rows, and a second all-to-all over *batch* to
   (E_l, C_p/n_b, D): its share of the slots, whole rows. Moved: T_b·D +
   E_l·C_p·D/n_b elements, against E_l·C_p·D for slabs of zeros summed
   over *batch* (GSPMD's form: ~6× more at olmoe's prefill_32k on 16×16);
3. the expert products for its E_l experts and its C_p/(n_b·n_s) slots
   only (*slots* splits them further, no all-to-all needed: the rows are
   the same there), the expert weights gathered over *batch* as the dense
   layers gather theirs (FSDP): no product is repeated across a mesh dim.
   The padding adds (C_p − C)/C of the expert FLOPs;
4. back: an all-gather over *slots*, the inverse all-to-all, each
   device's gated contributions of its experts summed per token on its D_c
   columns, an all-reduce of (T, D_c) over *experts*, and the inverse of
   step 2's first all-to-all to (T_b, D).

Per device and layer that is T_b·k ids and gates, 3·T_b·D + 2·E_l·C_p·D/n_b
elements of activations, plus the expert weights' FSDP gather; on one card
(n = 1 everywhere) every collective is of one rank. The sum over experts
on other devices is a sum of partial sums, so on a mesh the output agrees
with :func:`moe_ffn` to f32 rounding, not bit for bit. Plain tensors take
:func:`moe_ffn`'s own path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..sharding import collectives as coll
from .layers import dense_init

Params = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, d_model: int, num_experts: int, moe_d_ff: int,
             dtype: torch.dtype = torch.float32) -> Params:
    """The router stays f32; the expert tensors (E, ·, ·) take fan_in = E
    from ``dense_init``, so their std is E^-0.5, as in the reference."""
    return {
        "router": dense_init(gen, (d_model, num_experts), dtype=torch.float32),
        "w_gate": dense_init(gen, (num_experts, d_model, moe_d_ff), dtype=dtype),
        "w_up": dense_init(gen, (num_experts, d_model, moe_d_ff), dtype=dtype),
        "w_down": dense_init(gen, (num_experts, moe_d_ff, d_model), dtype=dtype),
    }


def moe_spec() -> Dict[str, Tuple]:
    """Logical axes of :func:`init_moe`'s tensors."""
    return {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "ffn"),
        "w_up": ("experts", "embed", "ffn"),
        "w_down": ("experts", "ffn", "embed"),
    }


def router_topk(x2d: torch.Tensor, router_w: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gates (T, k) normalised, expert_idx (T, k), full probs (T, E))."""
    logits = x2d.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E · Σ_e f_e · P_e."""
    counts = torch.bincount(idx.reshape(-1), minlength=num_experts).float()
    f = counts / max(idx.numel(), 1)
    p = probs.mean(dim=0)
    return num_experts * torch.sum(f * p)


def capacity(tokens: int, k: int, num_experts: int, capacity_factor: float) -> int:
    """Slots per expert, with Python's ``round`` (half to even), as the reference."""
    return int(max(1, round(tokens * k / num_experts * capacity_factor)))


def expert_swiglu(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor) -> torch.Tensor:
    """The experts as batched products: (E, C, D) → (E, C, D). Expert
    tensors of another dtype than ``buf`` are cast to it one expert at a
    time, each only while that expert's products run (a wide buffer over
    narrow weights holds one expert's cast copy at a time). The gate
    ``silu(g) · u`` is B8 (:func:`repro_torch.kernels.ops.silu_mul`)."""
    if w_gate.dtype == buf.dtype:
        h = ops.silu_mul(torch.bmm(buf, w_gate), torch.bmm(buf, w_up))
        return torch.bmm(h, w_down)
    return torch.cat([expert_swiglu(buf[e:e + 1], w_gate[e:e + 1].to(buf.dtype),
                                    w_up[e:e + 1].to(buf.dtype), w_down[e:e + 1].to(buf.dtype))
                      for e in range(buf.shape[0])])


class Plan(NamedTuple):
    """The sort dispatch of (T, k) assignments, in sorted order."""

    order: torch.Tensor                  # (T·k,) the stable argsort by expert id
    expert: torch.Tensor                 # (T·k,) expert of each sorted assignment
    token: torch.Tensor                  # (T·k,) its token
    keep: torch.Tensor                   # (T·k,) within its expert's capacity
    slot: torch.Tensor                   # (T·k,) its slot; the capacity where dropped
    kept: torch.Tensor                   # (E,) int32, min(assignments to e, capacity)


class Routes(NamedTuple):
    """The route table of one MoE layer, token-major: what B2's fill and
    combine read (:func:`route_table`). The buffer's capacity and its first
    expert are the ones the table was made with."""

    dest: torch.Tensor                   # (T, k) int32: e_l·cap + slot, or -1 - e dropped
    gate: torch.Tensor                   # (T, k) f32, as ``router_topk`` returns them
    kept: torch.Tensor                   # (E_l,) int32: each expert's rows in ``dest``


def dispatch_plan(idx: torch.Tensor, num_experts: int, cap: int) -> Plan:
    """The reference's dispatch of expert ids ``idx`` (T, k): assignments
    grouped by expert, stable within an expert; the rank within the
    expert's group is the position less the group's first position."""
    t, k = idx.shape
    flat_expert = idx.reshape(-1)                                   # (t·k,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    positions = torch.arange(t * k, device=idx.device)
    experts = torch.arange(num_experts + 1, device=idx.device, dtype=sorted_expert.dtype)
    bounds = torch.searchsorted(sorted_expert, experts)             # (E+1,) group starts, T·k
    rank = positions - bounds[:-1][sorted_expert]
    keep = rank < cap
    slot = torch.where(keep, rank, torch.full_like(rank, cap))      # overflow → slot C
    kept = torch.diff(bounds).clamp_(max=cap).to(torch.int32)
    return Plan(order, sorted_expert, order // k, keep, slot, kept)


def route_table(plan: Plan, gates: torch.Tensor, cap: int, expert0: int = 0,
                experts: int = 0) -> Routes:
    """The plan token-major, by one scatter through its order: token t's
    j-th assignment goes to row ``(e - expert0)·cap + slot`` of the
    (``experts``, cap, D) buffer where it is kept and its expert is among
    the table's ``experts`` (0: all of them), else it is the marker
    ``-1 - e``, which keeps the expert id (the combine adds by it). ``cap``
    may exceed the plan's capacity (the mesh's padded one): slots past an
    expert's kept count are empty. ``gates`` (T, k) f32 as ``router_topk``
    returns them."""
    t, k = gates.shape
    local, keep, kept = plan.expert, plan.keep, plan.kept
    if experts:
        local = plan.expert - expert0
        keep = keep & (local >= 0) & (local < experts)
        kept = kept[expert0:expert0 + experts]
    routed = torch.where(keep, plan.slot.add(local, alpha=cap), -1 - plan.expert)
    dest = torch.empty((t, k), dtype=torch.int32, device=gates.device)
    dest.view(-1)[plan.order] = routed.to(torch.int32)
    return Routes(dest, gates, kept)


def moe_ffn(params: Params, x: torch.Tensor, num_experts: int, k: int,
            capacity_factor: float = 1.25, return_aux: bool = False):
    """Sort-based capacity-limited top-k MoE on x (B, S, D). On a ``DTensor``
    x, the mesh path (module docstring), which returns no auxiliary loss."""
    if type(x) is not torch.Tensor and hasattr(x, "device_mesh"):
        if return_aux:
            raise NotImplementedError("moe_ffn on a mesh returns no auxiliary loss")
        return _moe_on_mesh(params, x, num_experts, k, capacity_factor)
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    gates, idx, probs = router_topk(x2d, params["router"], k)
    cap = capacity(t, k, num_experts, capacity_factor)
    plan = dispatch_plan(idx, num_experts, cap)
    routes = route_table(plan, gates, cap)

    wdt = torch.promote_types(x.dtype, params["w_gate"].dtype)
    buf = ops.fill_expert_slots(x2d.to(wdt).contiguous(), routes.dest, routes.kept,
                                cap)                                        # (E, C, D)
    y = expert_swiglu(buf, params["w_gate"], params["w_up"], params["w_down"])
    out2d = ops.combine_expert_rows(y.contiguous(), routes.dest, routes.gate, kept=routes.kept)
    out = out2d.reshape(b, s, d).to(x.dtype)
    if return_aux:
        return out, load_balance_loss(probs, idx, num_experts)
    return out


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoELayout:
    """One device's place in the mesh path's three groups: each group's
    size and the device's rank in it (major first)."""

    n_batch: int = 1
    n_experts: int = 1
    n_slots: int = 1
    batch: int = 0
    experts: int = 0
    slots: int = 0

    @property
    def sizes(self) -> Dict[str, int]:
        return {"batch": self.n_batch, "experts": self.n_experts, "slots": self.n_slots}

    def at(self, coords: Dict[str, int]) -> "MoELayout":
        return MoELayout(self.n_batch, self.n_experts, self.n_slots, coords["batch"],
                         coords["experts"], coords["slots"])


def padded_capacity(cap: int, lay: MoELayout) -> int:
    """The capacity rounded up to a multiple of the devices the slots are
    split over (*batch* × *slots*)."""
    n = lay.n_batch * lay.n_slots
    return -(-cap // n) * n


def _to_pieces(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``t`` split into n pieces along ``dim``, the pieces along a new dim 0,
    flattened into dim 0 (the all-to-all's layout)."""
    if dim == 0:
        return t
    return t.unflatten(dim, (n, t.shape[dim] // n)).movedim(dim, 0).flatten(0, 1)


def _from_pieces(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """The inverse layout: dim 0's n pieces laid side by side along ``dim``
    (of a piece)."""
    if dim == 0:
        return t
    return t.unflatten(0, (n, t.shape[0] // n)).movedim(0, dim).flatten(dim, dim + 1)


def moe_device_body(x2d: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor, k: int, capacity_factor: float,
                    tokens: int, lay: MoELayout) -> coll.Body:
    """One device's part of the mesh path (module docstring), a generator
    of its collectives (:mod:`repro_torch.sharding.collectives`). Takes this
    device's tokens x2d (T_b, D), the router (D, E) whole, its experts'
    tensors (E_l, ·, ·) whole; ``tokens`` is T. Returns (its tokens'
    output (T_b, D) in x's dtype, the global :class:`Plan`, the padded
    capacity)."""
    d = x2d.shape[1]
    num_experts = router_w.shape[1]
    e_local = w_gate.shape[0]
    nb = lay.n_batch
    router_w = yield coll.sum_grads(router_w, "batch")
    gates, idx, _ = router_topk(x2d, router_w, k)
    idx_all = yield coll.gather(idx, "batch")
    gates_all = yield coll.gather(gates, "batch", grad="sum", grad_sum="experts")
    cap = capacity(tokens, k, num_experts, capacity_factor)
    plan = dispatch_plan(idx_all, num_experts, cap)
    capp = padded_capacity(cap, lay)

    # its experts' routes at the padded capacity; the slots from cap to capp stay empty
    e0 = lay.experts * e_local
    routes = route_table(plan, gates_all, capp, e0, e_local)

    wdt = torch.promote_types(x2d.dtype, w_gate.dtype)
    dp = -(-d // nb) * nb                # D padded to a multiple of the batch group
    xe = yield coll.sum_grads(x2d.to(wdt), ("experts", "slots"))
    xe = F.pad(xe, (0, dp - d))
    cols = yield coll.all_to_all(_to_pieces(xe, nb, 1), "batch")    # (T, D_c)
    slab = ops.fill_expert_slots(cols.contiguous(), routes.dest, routes.kept,
                                 capp)                              # (E_l, C_p, D_c)
    rows = yield coll.all_to_all(_to_pieces(slab, nb, 1), "batch")
    rows = _from_pieces(rows, nb, 2)[..., :d]                       # (E_l, C_p/n_b, D)
    cs = rows.shape[1] // lay.n_slots
    rows = rows[:, lay.slots * cs:(lay.slots + 1) * cs]

    weights = []
    for w in (w_gate, w_up, w_down):
        w = yield coll.sum_grads(w, ("batch", "slots"))
        weights.append(w)
    y = expert_swiglu(rows, *weights)                               # (E_l, C_s, D)

    y = yield coll.gather(y.transpose(0, 1), "slots")
    y = F.pad(y.transpose(0, 1), (0, dp - d))                       # (E_l, C_p/n_b, D_p)
    y = yield coll.all_to_all(_to_pieces(y, nb, 2), "batch")
    y = _from_pieces(y, nb, 1)                                      # (E_l, C_p, D_c)

    part = ops.combine_expert_rows(y.contiguous(), routes.dest, routes.gate, e0,
                                   routes.kept)                     # (T, D_c)
    part = yield coll.reduce(part, "experts")
    out = yield coll.all_to_all(_to_pieces(part, nb, 0), "batch")
    out = _from_pieces(out, nb, 1)[:, :d]                           # (T_b, D)
    return out.to(x2d.dtype), plan, capp


def _moe_on_mesh(params: Params, x, num_experts: int, k: int, capacity_factor: float):
    """:func:`moe_device_body` on every device of x's mesh, inside
    ``local_map``. x keeps its batch sharding where the batch divides (the
    *batch* group) and is replicated elsewhere; the expert tensors keep E
    sharded where E divides (*experts*) and are gathered elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    b, s, d = x.shape
    ndim = mesh.ndim
    router, w_gate, w_up, w_down = (params[n] for n in ("router", "w_gate", "w_up", "w_down"))
    groups = {"batch": [], "experts": [], "slots": []}
    for i in range(ndim):
        n = mesh.size(i)
        if w_gate.placements[i] == Shard(0) and num_experts % n == 0:
            groups["experts"].append(i)
        elif x.placements[i] == Shard(0) and b % n == 0:
            groups["batch"].append(i)
        else:
            groups["slots"].append(i)
    sizes = {g: math.prod(mesh.size(i) for i in dims) for g, dims in groups.items()}
    r = Replicate()
    x_pl = [Shard(0) if i in groups["batch"] else r for i in range(ndim)]
    w_pl = [Shard(0) if i in groups["experts"] else r for i in range(ndim)]

    def local(x, router, w_gate, w_up, w_down):
        lay = MoELayout(sizes["batch"], sizes["experts"], sizes["slots"]).at(
            {g: coll.flat_rank(mesh, dims) for g, dims in groups.items()})
        body = moe_device_body(x.reshape(-1, d), router, w_gate, w_up, w_down, k,
                               capacity_factor, b * s, lay)
        return coll.on_mesh(body, mesh, groups)[0].reshape(x.shape)

    return local_map(local, out_placements=x_pl,
                     in_placements=(x_pl, [r] * ndim, w_pl, w_pl, w_pl), device_mesh=mesh)(
        x.redistribute(mesh, x_pl), router.redistribute(mesh, [r] * ndim),
        *(w.redistribute(mesh, w_pl) for w in (w_gate, w_up, w_down)))


def moe_ffn_dense(params: Params, x: torch.Tensor, num_experts: int, k: int) -> torch.Tensor:
    """Oracle: every expert for every token, masked by the routing (no drops)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, idx, _ = router_topk(x2d, params["router"], k)
    g = torch.einsum("td,edf->tef", x2d, params["w_gate"])
    u = torch.einsum("td,edf->tef", x2d, params["w_up"])
    y = torch.einsum("tef,efd->ted", F.silu(g) * u, params["w_down"])   # (T, E, D)
    weight = torch.zeros((b * s, num_experts), dtype=y.dtype, device=y.device)
    weight.scatter_(1, idx, gates.to(y.dtype))
    out = torch.einsum("ted,te->td", y, weight)
    return out.reshape(b, s, d)
