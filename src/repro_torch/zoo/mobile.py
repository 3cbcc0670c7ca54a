"""The paper's nine mobile networks as schedulable layer DAGs (Table 6);
port of ``repro.zoo.mobile``.

Two faces per model:

* a **cost graph** (:class:`~repro_torch.core.graph.ModelGraph`), a copy of
  the reference's: the same layers, edges, MACs and bytes, so the same
  Merkle keys;
* an **executable reduction** (:class:`ExecutableMobileModel`) — a real
  PyTorch conv network with the same DAG topology, on the card unless the
  caller asks for the CPU, used by the
  :class:`~repro_torch.core.profiler.TorchExecBackend` and by the Runtime's
  engines.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.graph import Edge, Layer, ModelGraph
from ..device import resolve_device
from ..precision import conv_precision
from .profiles import MODEL_NAMES, MODEL_SPECS

def _mac_profile(n: int) -> np.ndarray:
    """Plausible per-layer MAC share: ramps up, peaks mid-network, tails off."""
    x = np.linspace(0.0, 1.0, n)
    w = 0.35 + np.sin(np.pi * x) ** 2 + 0.25 * x
    return w / w.sum()


def _activation_bytes(n: int, input_bytes: int) -> List[int]:
    """Activation sizes: decay from input size as resolution drops."""
    sizes = []
    for i in range(n):
        decay = 0.5 ** (3.0 * i / max(n - 1, 1))  # ~8x total reduction
        sizes.append(max(int(input_bytes * decay), 4096))
    return sizes


def _skip_positions(n: int) -> List[int]:
    """Indices whose layer merges a skip connection (FPN/residual style)."""
    if n < 8:
        return []
    return [i for i in range(4, n - 1, 5)]


def make_cost_graph(name: str) -> ModelGraph:
    """Build the schedulable cost DAG calibrated to Table 6 totals."""
    spec = MODEL_SPECS[name]
    n = int(spec["layers"])
    h, w = spec["input"][1], spec["input"][2]
    input_bytes = int(h * w * 3 * 4)
    mac_share = _mac_profile(n)
    act = _activation_bytes(n, input_bytes)
    skips = set(_skip_positions(n))
    layers: List[Layer] = []
    param_share = mac_share / mac_share.sum()
    for i in range(n):
        op = "add_merge" if i in skips else ("conv" if i % 3 else "dwconv")
        attrs: Tuple[Tuple[str, object], ...] = (("model", name),)
        if i == 0:
            attrs = attrs + (("input_bytes", input_bytes),)
        layers.append(
            Layer(
                index=i,
                name=f"{name}.{i}",
                op_type=op,
                macs=float(spec["macs"] * mac_share[i]),
                param_bytes=int(spec["params"] * 4 * param_share[i]),
                out_bytes=act[i],
                attrs=attrs,
            )
        )
    edges: List[Edge] = []
    k = 0
    for i in range(n - 1):
        edges.append(Edge(index=k, src=i, dst=i + 1, bytes_=act[i]))
        k += 1
    for s in sorted(skips):
        src = s - 3
        if src >= 0:
            edges.append(Edge(index=k, src=src, dst=s, bytes_=act[src]))
            k += 1
    return ModelGraph(name, layers, edges)


def all_cost_graphs() -> Dict[str, ModelGraph]:
    return {name: make_cost_graph(name) for name in MODEL_NAMES}


# ---------------------------------------------------------------------------
# Executable reductions: real PyTorch conv nets with the same topology.
# ---------------------------------------------------------------------------

#: compute dtype of each dtype gene: the reference's map (``_np_dtype``)
COMPUTE_DTYPES = {"fp32": torch.float32, "fp16": torch.bfloat16, "int8": torch.bfloat16}


class ExecutableMobileModel:
    """A small real conv network matching a cost graph's DAG topology.

    Tensors are NHWC at a subgraph's boundary. A ``conv``/``dwconv`` layer
    is a 3×3, stride 1, "SAME" convolution + ReLU over a channels-last view
    of that memory; an ``add_merge`` layer sums (chain_input, skip_input) +
    ReLU. ``build_subgraph_fn`` returns a function computing the subgraph's
    outputs from its boundary inputs, with example inputs — what the
    profiler times and the Runtime engines execute. Both are built once per
    ``(layer_ids, dtype)`` and cached, so a dispatch allocates nothing.

    ``weights`` maps each conv layer to its HWIO float32 array (the
    reference's ``_weights``; :func:`repro_torch.models.convert.zoo_weights_from_jax`
    carries them across). Without it they are drawn N(0, 0.05²) from a
    ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(
        self,
        name: str,
        channels: int = 8,
        spatial: int = 16,
        seed: int = 0,
        weights: Optional[Mapping[int, np.ndarray]] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.name = name
        self.graph = make_cost_graph(name)
        self.channels = channels
        self.spatial = spatial
        self.device = resolve_device(device)
        if weights is None:
            gen = torch.Generator().manual_seed(seed)
            weights = {
                layer.index: (torch.randn((3, 3, channels, channels), generator=gen) * 0.05).numpy()
                for layer in self.graph.layers if layer.op_type in ("conv", "dwconv")
            }
        oihw = {lid: torch.from_numpy(np.asarray(w, np.float32)).permute(3, 2, 0, 1).contiguous()
                for lid, w in weights.items()}
        # one copy per compute dtype, as the reference casts at each call
        self._weights = {dt: {lid: w.to(self.device, dt) for lid, w in oihw.items()}
                         for dt in set(COMPUTE_DTYPES.values())}
        self._built: Dict[Tuple[Tuple[int, ...], str], Tuple[Callable, Tuple]] = {}
        self._lock = threading.Lock()

    # -- layer semantics -------------------------------------------------------
    def _apply_layer(self, lid: int, inputs: Sequence[torch.Tensor],
                     dtype: torch.dtype) -> torch.Tensor:
        layer = self.graph.layers[lid]
        x = inputs[0]
        if layer.op_type == "add_merge":
            out = x
            for other in inputs[1:]:
                out = out + other
            return torch.relu(out)
        w = self._weights[dtype][lid]
        xc = x.permute(0, 3, 1, 2)           # NCHW view of NHWC memory: channels-last
        if conv_precision() == "bfloat16":
            y = F.conv2d(xc.bfloat16(), w.bfloat16(), padding=1).to(x.dtype)
        else:
            y = F.conv2d(xc, w, padding=1)
        return torch.relu(y).permute(0, 2, 3, 1)

    def input_shape(self) -> Tuple[int, int, int, int]:
        return (1, self.spatial, self.spatial, self.channels)

    def build_subgraph_fn(
        self, layer_ids: Sequence[int], dtype: str = "fp32"
    ) -> Tuple[Callable, Tuple]:
        """(fn, example_args) computing this subgraph from boundary inputs."""
        key = (tuple(sorted(layer_ids)), dtype)
        with self._lock:
            built = self._built.get(key)
            if built is None:
                built = self._built[key] = self._build(key[0], dtype)
        return built

    def _build(self, ids: Tuple[int, ...], dtype: str) -> Tuple[Callable, Tuple]:
        dt = COMPUTE_DTYPES[dtype]
        id_set = set(ids)
        # boundary inputs: one per external dependency + model input for sources
        ext_inputs: List[Tuple[int, int]] = []  # (src_layer, dst_layer)
        for lid in ids:
            preds = [e.src for e in self.graph.in_edges[lid]]
            if not preds:
                ext_inputs.append((-1, lid))
            for p in preds:
                if p not in id_set:
                    ext_inputs.append((p, lid))
        out_ids = [lid for lid in ids
                   if all(e.dst not in id_set for e in self.graph.out_edges[lid])
                   or not self.graph.out_edges[lid]]

        def fn(*args):
            env: Dict[int, torch.Tensor] = {}
            ext = {pair: a for pair, a in zip(ext_inputs, args)}
            for lid in ids:
                preds = [e.src for e in self.graph.in_edges[lid]]
                ins = []
                if not preds:
                    ins.append(ext[(-1, lid)])
                for p in preds:
                    ins.append(env[p] if p in id_set else ext[(p, lid)])
                env[lid] = self._apply_layer(lid, ins, dt)
            outs = [env[lid].contiguous() for lid in out_ids]
            return outs[0] if len(outs) == 1 else tuple(outs)

        shape = self.input_shape()
        args = tuple(torch.full(shape, 0.1, dtype=dt, device=self.device) for _ in ext_inputs)
        return fn, args


def executable_zoo(
    names: Sequence[str] = MODEL_NAMES, channels: int = 8, spatial: int = 16,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, ExecutableMobileModel]:
    return {n: ExecutableMobileModel(n, channels=channels, spatial=spatial, device=device)
            for n in names}
