"""How the model's ops run on DTensor shards.

A model whose weights are DTensors (placed by ``launch/sharding_rules``)
runs most of its ops as DTensor ops.  The ops below DTensor has no
strategy for, or would run gathered where the reference's partitioner
splits them, so they run shard by shard through ``local_map``, each as
its plain version on the local shards.  This module is the one place
that decides how: the model's modules call it where their input is a
DTensor and keep their plain arithmetic.

A :class:`Plan` names the role each mesh dim plays in such an op: it
shards the op's batch rows (``b``), an independent split of the work
(heads or channels ``s``, experts ``e``, the vocabulary ``v``, ...), or
nothing (None: the op's inputs are gathered over it).  Each input and
output says which of its dims a role shards; from that the plan gives its
placements, and its gradient's: an input that a role's shards all read
whole (a weight read by every batch shard, the tokens read by every
expert shard) gets back the sum of their gradients.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

__all__ = ["SUM", "WHOLE", "Plan", "is_sharded", "summed", "unshard",
           "constrain", "pin_grad", "whole_heads", "whole_heads_grad",
           "vocab_pick", "sdpa", "batch_update", "causal_conv", "ssd",
           "routed_experts"]

SUM = "sum"        # an output's role: its shards hold partial sums
WHOLE = "whole"    # an input's role: read whole, its gradient whole too


def is_sharded(t) -> bool:
    return isinstance(t, DTensor)


class Plan:
    """For each mesh dim, the role it plays in an op run shard by shard,
    or None (gathered)."""

    def __init__(self, mesh, roles):
        self.mesh, self.roles = mesh, list(roles)

    @classmethod
    def of(cls, t: DTensor, **dims) -> "Plan":
        """Each mesh dim gets the role whose dim (``dims[role]``) of t it
        shards."""
        want = {d % t.ndim: r for r, d in dims.items()}
        return cls(t.device_mesh,
                   [want.get(p.dim) if p.is_shard() else None
                    for p in t.placements])

    def also(self, t, **dims) -> "Plan":
        """The roles of t's shards on the mesh dims that have none yet."""
        if is_sharded(t):
            other = Plan.of(t, **dims).roles
            self.roles = [r if r is not None else o
                          for r, o in zip(self.roles, other)]
        return self

    def keep(self, role: str, ok) -> "Plan":
        """``role`` dropped (its dims gathered) unless ok(its ways)."""
        if not ok(self.ways(role)):
            self.roles = [None if r == role else r for r in self.roles]
        return self

    def _dims(self, role):
        return [i for i, r in enumerate(self.roles) if r == role]

    def ways(self, role: str) -> int:
        return math.prod(self.mesh.size(i) for i in self._dims(role))

    def index(self, role: str) -> int:
        """This rank's shard among ``role``'s, the first mesh dim major."""
        coord, r = self.mesh.get_coordinate(), 0
        for i in self._dims(role):
            r = r * self.mesh.size(i) + coord[i]
        return r

    def placements(self, dims: dict, grad: bool = False) -> tuple:
        """The placements of a tensor whose dim ``dims[role]`` each role
        shards (SUM: partial sums, WHOLE: read whole); a role it lacks
        reads it whole, and its gradient (``grad``) is then a sum."""
        out = []
        for r in self.roles:
            d = dims.get(r) if r is not None else None
            if r is None or d == WHOLE:
                out.append(Replicate())
            elif d == SUM:
                out.append(Partial())
            elif d is None:
                out.append(Partial() if grad else Replicate())
            else:
                out.append(Shard(d))
        return tuple(out)

    def run(self, fn, ins, outs):
        """fn on the local shards of ``ins``, (tensor, dims) pairs (a plain
        tensor is read whole; None stays None), returning ``outs``: the
        dims of each output, one dims for one output, None for none."""
        keep = [i for i, (t, _) in enumerate(ins) if t is not None]
        args = [_replicated(ins[i][0], self.mesh) for i in keep]

        def local(*a):
            full = [None] * len(ins)
            for i, t in zip(keep, a):
                full[i] = t
            return fn(*full)
        if outs is None:
            out_pl = None
        elif isinstance(outs, dict):
            # one output's placements are a list, a tuple is one a value
            out_pl = list(self.placements(outs))
        else:
            out_pl = tuple(self.placements(o) for o in outs)
        return local_map(
            local, out_placements=out_pl,
            in_placements=tuple(self.placements(ins[i][1]) for i in keep),
            in_grad_placements=tuple(self.placements(ins[i][1], grad=True)
                                     for i in keep),
            device_mesh=self.mesh, redistribute_inputs=True)(*args)


def _replicated(t, mesh) -> DTensor:
    if is_sharded(t):
        return t
    return DTensor.from_local(torch.as_tensor(t), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def _gather(t: DTensor, which) -> DTensor:
    if not any(which(p) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if which(p) else p
                                          for p in t.placements])


def summed(x):
    """x with partial sums (a row-sharded product's output) summed, an
    all-reduce; x itself if it holds none or is a plain tensor."""
    return _gather(x, lambda p: p.is_partial()) if is_sharded(x) else x


def unshard(x, dim: int):
    """x gathered along ``dim``; x itself if a plain tensor."""
    return _gather(x, lambda p: p == Shard(dim % x.ndim)) \
        if is_sharded(x) else x


def constrain(x, sharding):
    """x redistributed to ``sharding`` (whose ``constrain`` does it, as
    ``launch/sharding_rules.NamedSharding``'s), the counterpart of the
    reference's ``with_sharding_constraint``; x if None."""
    return x if sharding is None else sharding.constrain(x)


class _PinGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def pin_grad(t):
    """t; a DTensor's gradient comes back in t's own placements, so
    DTensor cannot carry a sequence-sharded gradient into the product
    that made t (where flattening batch and sequence would leave a
    strided shard of both, slow to propagate and refused by older
    DTensor)."""
    return _PinGrad.apply(t) if is_sharded(t) and t.requires_grad else t


def whole_heads(t, h: int):
    """t (..., h·dh) gathered on its last dim where that dim's shards are
    not whole heads (8 kv heads on a 16-way axis), as the reference's
    partitioner reshards it; t itself if a plain tensor."""
    if not is_sharded(t):
        return t
    last = Shard(t.ndim - 1)
    n = math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                  if p == last)
    return t if h % n == 0 else _gather(t, lambda p: p == last)


class _WholeHeadGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, h):
        ctx.h = h
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return whole_heads(g, ctx.h), None


def whole_heads_grad(t, h: int):
    """t (..., h·dh); a DTensor's gradient comes back in whole heads, so
    the head merge before it can unflatten it."""
    return _WholeHeadGrad.apply(t, h) if is_sharded(t) else t


def vocab_pick(take, table, index, vocab_dim: int, batched: bool):
    """``take(table, index)``, index's values naming entries of table
    along ``vocab_dim``: the embedding lookup (``t[i]``, vocab_dim 0) and
    the cross entropy's gold logits (a gather, vocab_dim -1, ``batched``:
    the table's dim 0 is index's batch).  A DTensor table is picked from
    vocabulary-parallel: each rank takes the entries in its slice of the
    vocabulary and zero for the rest, and the sum over the vocabulary's
    mesh dims is taken at once (an all-reduce), not left to every op
    after.  Other shards of the table (FSDP's) are gathered."""
    if not is_sharded(table):
        return take(table, index.long())
    vd = vocab_dim % table.ndim
    t_dims = {"v": vd, "b": 0} if batched else {"v": vd}
    plan = Plan.of(table, **t_dims).also(index, b=0)
    r = plan.index("v")

    def pick(t_l, i_l):
        rows = t_l.shape[vd]
        local = i_l.long() - r * rows
        hit = (local >= 0) & (local < rows)
        out = take(t_l, local.clamp(0, rows - 1))
        return torch.where(hit[..., None], out,
                           torch.zeros((), dtype=out.dtype,
                                       device=out.device))
    return summed(plan.run(pick, [(table, t_dims), (index, {"b": 0})],
                           {"v": SUM, "b": 0}))


def _rows(t, B: int):
    """A number or a 0-d tensor as a (B,) row; None and rows unchanged."""
    if t is None or is_sharded(t):
        return t
    t = torch.as_tensor(t)
    return t.expand(B) if t.ndim == 0 else t


def sdpa(local_sdpa, q, k, v, *, q_offset, kv_len, kpos, **kw):
    """Attention of DTensor q (B,Sq,Hq,D), k, v (B,Sk,Hkv,D): each rank
    attends its own batch rows and, where the query heads split evenly
    over the mesh dims that shard them, its own query heads, with the kv
    heads they read: its own share where the kv heads split too, else
    the one kv head its query heads share (8 kv heads, 64 query heads on
    a 16-way axis: 4 query heads a rank, one kv head for every two
    ranks).  The rest (a sequence-sharded query, heads that do not
    split) is gathered first.  Batch and head slices of attention are
    independent, so this is the layer's own arithmetic, as the
    reference's partitioner splits it."""
    Hq, Hkv = q.shape[2], k.shape[2]
    plan = Plan.of(q, b=0, s=2).keep(
        "s", lambda n: Hq % n == 0 and (Hkv % n == 0 or n % Hkv == 0))
    n, r = plan.ways("s"), plan.index("s")
    heads = {"b": 0, "s": 2}
    kv_dims = heads if Hkv % n == 0 else {"b": 0}
    row = {"b": 0}

    def local(q_l, k_l, v_l, off, kl, kp):
        if Hkv % n:
            h = r // (n // Hkv)
            k_l, v_l = k_l[:, :, h:h + 1], v_l[:, :, h:h + 1]
        return local_sdpa(q_l, k_l, v_l, q_offset=off, kv_len=kl, kpos=kp,
                          **kw)
    B = q.shape[0]
    return plan.run(local, [(q, heads), (k, kv_dims), (v, kv_dims),
                            (_rows(q_offset, B), row), (kv_len, row),
                            (kpos, row)], heads)


def batch_update(local_update, cache: DTensor, new, idx) -> None:
    """Write new (B,S,...) into the DTensor cache (B,S_max,...) at per-row
    offset idx, in place, each rank writing its own shard (DTensor has no
    in-place ``index_put_`` for a sharded cache): batch and head shards
    take their rows of ``new`` and ``idx`` and write them as on one device
    (``local_update``).  Where the cache's sequence is sharded (a batch
    too small to shard), each rank blends the updated rows that fall in
    its slice of the sequence into the slice, the start clamped to
    [0, S_max - S] as on one device."""
    # every dim of the cache keeps its shards: the write is in place
    rest = {f"d{i}": i for i in range(2, cache.ndim)}
    plan = Plan.of(cache, b=0, seq=1, **rest)
    S, S_max = new.shape[1], cache.shape[1]
    split_seq, shard = plan.ways("seq") > 1, plan.index("seq")

    def write(cache_l, new_l, idx_l):
        if not split_seq:
            local_update(cache_l, new_l, idx_l)
            return
        S_l = cache_l.shape[1]
        start = idx_l.long().clamp(0, S_max - S)
        pos = shard * S_l + torch.arange(S_l, device=cache_l.device)
        j = pos[None, :] - start[:, None]                   # (B, S_l)
        hit = (j >= 0) & (j < S)
        tail = (1,) * (cache_l.ndim - 2)
        src = torch.gather(new_l.to(cache_l.dtype), 1, j.clamp(0, S - 1)
                           .reshape(*j.shape, *tail)
                           .expand(-1, -1, *cache_l.shape[2:]))
        cache_l.copy_(torch.where(hit.reshape(*hit.shape, *tail), src,
                                  cache_l))
    plan.run(write, [(cache, {"b": 0, "seq": 1, **rest}),
                     (new, {"b": 0, **rest}), (idx, {"b": 0})], None)


def causal_conv(local_conv, xBC, w, b):
    """The depthwise causal conv of DTensor xBC (B,S,C), w (W,C), b (C,):
    each rank convolves its own batch rows and, where they split evenly,
    its own channels."""
    C = xBC.shape[2]
    plan = Plan.of(xBC, b=0, s=2).keep("s", lambda n: C % n == 0)
    rows_ch = {"b": 0, "s": 2}
    return plan.run(local_conv, [(xBC, rows_ch), (w, {"s": 1}),
                                 (b, {"s": 0})], rows_ch)


def ssd(local_ssd, xh, Bmat, Cmat, dt, log_a, D, h0):
    """The chunked SSD of DTensor xh (B,S,H,P), B/C (B,S,N), dt/log_a
    (B,S,H), D (H,), h0 (B,H,P,N): each rank runs its own batch rows and,
    where they split evenly, its own heads (the recurrence is independent
    across both).  ``local_ssd(xh, Bmat, Cmat, dt, log_a, D, H=, h0=)``
    runs the plain SSD on a rank's shards."""
    H = xh.shape[2]
    plan = Plan.of(xh, b=0, s=2).keep("s", lambda n: H % n == 0)
    H_l = H // plan.ways("s")
    heads, row = {"b": 0, "s": 2}, {"b": 0}

    def local(xh, Bmat, Cmat, dt, log_a, D, h0):
        return local_ssd(xh, Bmat, Cmat, dt, log_a, D, H=H_l, h0=h0)
    return plan.run(local, [(xh, heads), (Bmat, row), (Cmat, row),
                            (dt, heads), (log_a, heads), (D, {"s": 0}),
                            (h0, {"b": 0, "s": 1})],
                    [heads, {"b": 0, "s": 1}])


def routed_experts(local_routed, x: DTensor, p):
    """A MoE layer's routed experts on DTensor x (B,S,d) and expert
    weights (E,...) (DTensor has no strategy for the dispatch's
    ``searchsorted``): every rank routes its tokens (whole over the mesh
    dims that shard the experts) over all E experts, runs its own
    experts (``local_routed(x_l, router, w_gate, w_up, w_down, r)``, r
    its shard of the experts) and combines what they return; the output
    is the sum of that over the expert shards.  Returns (y, aux)."""
    plan = Plan.of(p.w_gate, e=0).also(x, b=0)
    r, n_e = plan.index("e"), plan.ways("e")

    def body(x_l, router, w_gate, w_up, w_down):
        y, aux = local_routed(x_l, router, w_gate, w_up, w_down, r)
        # every expert shard computes the same aux: each holds 1/n_e
        return y, (aux / n_e).reshape(1).expand(x_l.shape[0])
    expert, row_sum = {"e": 0}, {"b": 0, "e": SUM}
    y, aux = plan.run(body, [(x, {"b": 0}), (p.router, {}),
                             (p.w_gate, expert), (p.w_up, expert),
                             (p.w_down, expert)], [row_sum, row_sum])
    return summed(y), summed(aux).mean()
