"""Per-device cost of one step, counted op by op as it runs
(``repro/roofline/hlo_cost.py``).

The reference reads flops, HBM bytes and collective bytes from XLA's
partitioned HLO.  Here :func:`analyze_step` runs the step itself under a
``TorchDispatchMode`` and counts each ATen op that reaches it.  A DTensor
op is not counted where it is called: the mode steps aside
(``NotImplemented``), DTensor redistributes and runs the op on its local
shards, and those local ops and the collectives they need reach the mode.
So every count is **per device**: the work of the rank this process is
(rank 0 of a fake group, whose shards are the shapes every rank holds).
The ops DTensor runs on global-shape stand-ins to infer an output's
shape (its sharding propagation) are not counted.

Model, the reference's:
    flops       2 · |output| · |contracted| for each matrix product
                (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``;
                ``matmul``, ``einsum`` and ``linear`` reach the mode as
                these, or whole under inference mode, and are then
                decomposed into them).  Only products count, as the
                reference counts only ``dot``.
    bytes       operands plus result of each op that touches memory.
                Views, aliases and allocations count nothing (a slice is
                a view here; its reader pays for what it reads).  In-place
                index updates and copies (``index_put_``, ``index_add_``,
                ``scatter*``, ``copy_`` into a cache slice) count 2× the
                bytes written, as the reference counts
                ``dynamic-update-slice`` and ``scatter``; gathers
                (``index``, ``index_select``, ``gather``, ``embedding``)
                count 2× their result, as ``gather`` and ``dynamic-slice``.
    collective  the result bytes of each collective, by kind (also
                counted in bytes, as the reference counts them).

Eager PyTorch has no ``while`` body to count once: a Python layer loop
runs every layer's ops, and a checkpoint's recomputation runs again in
the backward, so both are counted as they run.  What the reference
scales by a trip count is here simply executed that many times.

``peak_bytes`` tracks the storages alive: those of the arguments, plus
each op's new result storage from its creation until it is freed.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["Cost", "analyze_step", "CostMode", "COLLECTIVES", "tensors_of"]

aten = torch.ops.aten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_PRODUCTS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
             aten.baddbmm.default, aten.mv.default, aten.dot.default}

#: composite ops made of products, which reach the mode whole where
#: autograd is off (inference mode) and are decomposed there
_COMPOSITE_PRODUCTS = {aten.matmul, aten.einsum, aten.linear,
                       aten.tensordot, aten.bilinear}

_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}

#: in-place index updates and copies -> the argument holding what they
#: write (a scatter of one value writes as many as its index has)
_UPDATES = {aten.index_put_.default: 2, aten.index_put.default: 2,
            aten.index_add_.default: 3, aten.index_add.default: 3,
            aten.scatter_.src: 3, aten.scatter.src: 3,
            aten.scatter_.value: 2, aten.scatter.value: 2,
            aten.scatter_add_.default: 3, aten.scatter_add.default: 3,
            aten.index_copy_.default: 3, aten.copy_.default: 1}

_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.detach.default, aten.alias.default,
         aten.lift_fresh.default, aten._local_scalar_dense.default}

# the collectives DTensor (functional) and the EP group (c10d) call: name
# of the op's overload packet -> (kind, index of the argument whose
# tensors are the result: None for the op's own output)
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": ("all-gather", None),
    "all_gather_into_tensor_coalesced": ("all-gather", None),
    "all_reduce": ("all-reduce", None),
    "all_reduce_coalesced": ("all-reduce", None),
    "reduce_scatter_tensor": ("reduce-scatter", None),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", None),
    "all_to_all_single": ("all-to-all", None),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "alltoall_base_": ("all-to-all", 0),
    "alltoall_": ("all-to-all", 0),
}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    peak_bytes: int = 0

    def collectives(self) -> dict:
        """The reference's ``collective_bytes_per_device``: bytes by
        kind, ``total`` and ``op_counts``."""
        out = {k: self.collective_by_kind.get(k, 0) for k in COLLECTIVES}
        out["total"] = self.collective_bytes
        out["op_counts"] = {k: self.collective_counts.get(k, 0)
                            for k in COLLECTIVES}
        return out


def tensors_of(tree) -> list:
    """Every tensor in ``tree`` (modules, dicts, lists, tuples, named
    tuples), each once."""
    seen, out = set(), []

    def visit(x):
        if isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                visit(t)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif isinstance(x, torch.Tensor) and id(x) not in seen:
            seen.add(id(x))
            out.append(x)
    visit(tree)
    return out


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _product_flops(func, args, out) -> float:
    a = args[1] if func in (aten.addmm.default, aten.baddbmm.default) \
        else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _writes(func) -> bool:
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


class CostMode(TorchDispatchMode):
    """Counts what reaches it into ``self.cost`` (module docstring)."""

    def __init__(self, args=()):
        super().__init__()
        self.cost = Cost()
        self._live = 0
        self._seen: dict = {}
        self._quiet = 0
        for t in tensors_of(args):
            self._track(t)

    # ---- live storages
    def _track(self, t: torch.Tensor) -> None:
        local = getattr(t, "_local_tensor", None)
        if local is not None:          # a DTensor: its shard's storage
            t = local
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._live += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

        def freed(_ref, key=key, n=n):
            self._live -= n
            self._seen.pop(key, None)
        self._seen[key] = weakref.ref(st, freed)

    @contextlib.contextmanager
    def quiet(self):
        """Ops inside are not counted (DTensor's sharding propagation)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # count its local ops instead
        if func._overloadpacket in _COMPOSITE_PRODUCTS:
            # under inference mode these arrive whole: count the products
            # they are made of
            with self:
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        coll = _COLLECTIVE_OPS.get(func._overloadpacket.__name__)
        if coll is not None and func.namespace in ("_c10d_functional",
                                                   "c10d"):
            kind, idx = coll
            n = _nbytes(out if idx is None else args[idx])
            c.collective_bytes += n
            c.collective_by_kind[kind] = c.collective_by_kind.get(kind, 0) + n
            c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
            c.bytes += n
            for t in _tensors(out):
                self._track(t)
            return
        if func in _PRODUCTS:
            c.flops += _product_flops(func, args, out)
        if func in _FREE or func.is_view or func.namespace in (
                "_c10d_functional", "c10d"):
            return
        if func in _UPDATES:
            c.bytes += 2 * _nbytes(args[_UPDATES[func]])
        elif func in _GATHERS:
            c.bytes += 2 * _nbytes(out)
        else:
            c.bytes += _nbytes((args, kwargs)) + (
                0 if _writes(func) else _nbytes(out))
        if not _writes(func):
            for t in _tensors(out):
                self._track(t)


@contextlib.contextmanager
def _quiet_propagation(mode: CostMode):
    """DTensor's sharding propagation runs ops on global-shape stand-ins
    (to learn an output's shape, and to trace an op's decomposition for
    its strategy); those runs are not the step's and are not counted.
    Both of its entry points, the cached one and the one it wraps, are
    quieted for the length of the ``with``."""
    prop = DTensor._op_dispatcher.sharding_propagator
    names = ("propagate_op_sharding", "propagate_op_sharding_non_cached")
    missing = [n for n in names if not hasattr(prop, n)]
    if missing:
        raise RuntimeError(
            f"this torch's ShardingPropagator has no {missing}; the count "
            "cannot tell its shape inference from the step's own ops")
    saved = {n: prop.__dict__.get(n) for n in names}

    def quieted(inner):
        def run(*a, **k):
            with mode.quiet():
                return inner(*a, **k)
        return run
    for n in names:
        setattr(prop, n, quieted(getattr(prop, n)))
    try:
        yield
    finally:
        for n, v in saved.items():
            if v is None:
                delattr(prop, n)          # the class's method again
            else:
                setattr(prop, n, v)


def analyze_step(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once under :class:`CostMode` and
    return the :class:`Cost` of the run, per device."""
    mode = CostMode((args, kwargs))
    with _quiet_propagation(mode), mode:
        fn(*args, **kwargs)
    return mode.cost
