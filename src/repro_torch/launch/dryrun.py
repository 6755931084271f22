"""Multi-pod dry-run: one step of every (arch × shape × mesh) combo, run
as a DTensor program on a fake process group (``repro/launch/dryrun.py``).

The reference lowers and compiles each step for 256 or 512 fake XLA
devices.  Here the same step, the port's own code, runs once as a
DTensor program on the 16×16 single-pod mesh or the 2×16×16 multi-pod
mesh of a fake process group (``launch/mesh.py:fake_world``): weights,
optimizer state, batch and cache are DTensors placed by the reference's
rules (``launch/sharding_rules.py``) whose local shards are ``meta``
tensors: no memory behind them and no data moved.  The mesh's device
type (``cuda`` unless ``cpu`` is asked for) sets how DTensor lays out
its collectives, as NCCL or gloo would take them.
``roofline/hlo_cost.analyze_step`` counts what rank 0 runs, per
device.  That the step runs to its end shows the
distribution is coherent; the counts feed the roofline
(``roofline/analysis.py``).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
    python -m repro_torch.launch.dryrun --arch lda --shape train_4k
Writes one JSON report per combo into ``reports/dryrun_torch/``, and
exits non-zero when any combo errs.

Report keys, against the reference's:
    flops_per_device, bytes_per_device     hlo_flops_per_device, hlo_bytes_
                                           per_device (counted as the step
                                           runs, not read from HLO)
    collective_bytes_per_device            the same: bytes by kind, total,
                                           op_counts
    trace_seconds                          compile_seconds
    memory                                 argument_bytes (the local shards,
                                           exact), output_bytes, peak_bytes
                                           (live storages while the step
                                           runs); no temp_bytes
    roofline_seconds, bottleneck           the same, over ``mesh.HW`` (the
                                           H100), the compute term at the
                                           rate of ``dtype``
    fits                                   peak_bytes within HW.HBM_BYTES
There is no ``xla_cost_analysis``.

Expert parallelism: DTensor has no strategy for the MoE dispatch's
``searchsorted``, so each MoE layer runs on its local shards through
``local_map``: ``launch/ep.py:make_ep_ctx`` over the mesh's 'model'
group, as the reference's ``shard_map`` runs ``moe_forward_ep``.  Where
the sequence is not a multiple of the model axis (decode), the layer is
the rank's share of ``moe_forward`` on its own experts, summed over the
axis: the rest of the model stays DTensor either way.

The paper's own workload (``--arch lda``): the port runs the W workers
of a Nomad sweep on one card, so its report is that of the one-card
sweep at the reference's shapes, computed from the fused kernel's bound
model (``roofline/analysis.sweep_work``), not traced.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from types import SimpleNamespace

import torch
from torch import nn
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import (ARCHS, INPUT_SHAPES, get_config,
                                 shape_applicable)
from repro_torch.launch import sharding_rules as rules
from repro_torch.launch.ep import make_ep_ctx
from repro_torch.launch.input_specs import abstract_batch
from repro_torch.launch.mesh import HW, fake_world, make_production_mesh
from repro_torch.models import sharded, transformer
from repro_torch.roofline.analysis import REPORTS, roofline_terms, sweep_work
from repro_torch.roofline.hlo_cost import analyze_step, tensors_of
from repro_torch.serve import serve_step as serve_mod
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.train_step import TrainState, make_train_step

__all__ = ["Lowered", "lower_arch", "lower_step", "lower_lda", "analyse",
           "lda_report", "dry_run", "one_device_cost", "main"]

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
LDA_MODEL = ("computed from the fused sweep kernel's bound model (every "
             "slot valid, every row touched), not traced; no collective, "
             "since the port's workers share one card's memory")


class Lowered(SimpleNamespace):
    """One combo ready to run: ``step(*args)``, the bytes of the args'
    local shards, the dtype's name and whether FSDP is on."""


def _local_bytes(tree) -> int:
    """Bytes of the local shards of the tensors in ``tree``."""
    total = 0
    for t in tensors_of(tree):
        t = getattr(t, "_local_tensor", t)
        total += t.numel() * t.element_size()
    return total


def _place(t: torch.Tensor, spec, mesh, requires_grad=False):
    return rules.with_sharding(t.to("meta"), spec, mesh,
                               requires_grad=requires_grad)


def _sharded_model(cfg, dtype, mesh, *, fsdp, attn_ms,
                   train: bool) -> transformer.Transformer:
    """The model built on ``meta``, each weight then replaced by a
    DTensor parameter placed by the rules."""
    model = transformer.Transformer(cfg, torch.Generator(), dtype,
                                    torch.device("meta"))
    specs = rules.param_specs(model, mesh, fsdp=fsdp,
                              attn_model_shard=attn_ms)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        dt = _place(p, specs[name], mesh)
        setattr(model.get_submodule(owner), leaf,
                nn.Parameter(dt, requires_grad=train))
    return model


def _train_state(model, mesh, specs) -> TrainState:
    """(params, AdamW m and v in f32 placed as the params, the step):
    the step is a real 0-d host tensor, since the update reads it on the
    host (its bias corrections)."""
    def moments():
        return {k: _place(torch.empty(p.shape, dtype=torch.float32,
                                      device="meta"), specs[k], mesh)
                for k, p in model.named_parameters()}
    return TrainState(params=model, opt=AdamWState(
        step=torch.tensor(0, dtype=torch.int32), m=moments(), v=moments()))


def _cache(cfg, B, S, dtype, mesh, ring: bool) -> dict:
    meta = transformer.init_cache(cfg, B, S, dtype, ring=ring,
                                  device="meta")
    specs = rules.cache_specs(meta, mesh)

    def place(tree, spec):
        if isinstance(tree, dict):
            return {k: place(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [place(v, s) for v, s in zip(tree, spec)]
        return _place(tree, spec, mesh)
    return place(meta, specs)


# ---------------------------------------------------------------------------
# Expert parallelism on the mesh.
# ---------------------------------------------------------------------------
def _mesh_ep(mesh, cfg, capacity_factor: float):
    """ep_ctx(moe, x) for ``transformer.forward`` on a mesh with a
    'model' axis, or None where EP is not viable (the reference's
    ``make_ep_ctx(mesh, cfg)``)."""
    names = list(mesh.mesh_dim_names)
    if "model" not in names:
        return None
    M = mesh.size(names.index("model"))
    group = mesh.get_group("model")
    ep = make_ep_ctx(M, cfg, group=group, capacity_factor=capacity_factor)
    if ep is None:
        return None
    bdims = [names.index(a) for a in rules.batch_axes(mesh)]
    plan = sharded.Plan(mesh, ["b" if i in bdims else "m" if n == "model"
                               else None for i, n in enumerate(names)])
    shared = bool(cfg.num_shared_experts)

    def weights(p):
        w = [p.router, p.w_gate, p.w_up, p.w_down]
        if shared:
            w += [p.shared.w_gate, p.shared.w_up, p.shared.w_down]
        return w

    def as_moe(w):
        p = SimpleNamespace(router=w[0], w_gate=w[1], w_up=w[2],
                            w_down=w[3])
        if shared:
            p.shared = SimpleNamespace(w_gate=w[4], w_up=w[5], w_down=w[6])
        return p

    def ep_body(x, *w):
        y, aux = ep(as_moe(w), x)
        return y, aux.reshape(1).expand(x.shape[0])

    # every 'model' rank holds all of x and takes its chunk, and its
    # gradient comes back whole (launch/ep.py); a weight's gradient holds
    # a rank's own tokens and is summed over both axes
    rows = {"b": 0, "m": sharded.WHOLE}
    w_dims = [{}, {"m": 0}, {"m": 0}, {"m": 0}] + [{}] * (3 * shared)

    def ctx(p, x):
        if x.shape[1] % M:
            # decode shapes: make_ep_ctx's fallback, moe_forward, whose
            # routed experts run on DTensors shard by shard
            return ep(p, x)
        y, aux = plan.run(ep_body, [(x, rows)] + list(zip(weights(p), w_dims)),
                          [rows, rows])
        return y, aux.mean()

    return ctx


# ---------------------------------------------------------------------------
# Lowering.
# ---------------------------------------------------------------------------
def lower_arch(arch, shape_name: str, mesh, *, fsdp=None,
               dtype: str = "f32", chunked_ce: bool = False,
               act_shard: bool = False, ring_kv: bool = False,
               layer_remat: bool = False, attn_replicate: bool = False,
               attn_seq_shard: bool = False, moe_cap: float = 1.25):
    """(a :class:`Lowered`, note), or (None, note) where the shape does
    not apply to the arch.  ``arch``: a name, or a ``ModelConfig``."""
    cfg = base = get_config(arch) if isinstance(arch, str) else arch
    spec = INPUT_SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        cfg = cfg.with_long_context()
    ok, note = shape_applicable(base, shape_name)
    if not ok:
        return None, note
    if fsdp is None:
        fsdp = cfg.param_count() * 2 > 8e9 * mesh.size() / 64
        fsdp = fsdp or cfg.param_count() > 50e9
    return lower_step(cfg, spec["kind"], spec["global_batch"],
                      spec["seq_len"], mesh, fsdp=fsdp, dtype=dtype,
                      chunked_ce=chunked_ce, act_shard=act_shard,
                      ring_kv=ring_kv, layer_remat=layer_remat,
                      attn_replicate=attn_replicate,
                      attn_seq_shard=attn_seq_shard, moe_cap=moe_cap), note


def lower_step(cfg, kind: str, B: int, S: int, mesh, *, fsdp: bool,
               dtype: str = "f32", chunked_ce: bool = False,
               act_shard: bool = False, ring_kv: bool = False,
               layer_remat: bool = False, attn_replicate: bool = False,
               attn_seq_shard: bool = False,
               moe_cap: float = 1.25) -> Lowered:
    """One step of ``kind`` (train / prefill / decode) at batch B and
    sequence S, its state placed on ``mesh`` by the rules."""
    tdtype = DTYPES[dtype]
    attn_ms = not attn_replicate
    act_sharding = rules.NamedSharding(
        mesh, rules.P(rules.batch_axes(mesh), None, None)) \
        if act_shard else None
    attn_seq_sharding = rules.NamedSharding(
        mesh, rules.P(rules.batch_axes(mesh), "model", None)) \
        if attn_seq_shard else None
    train = kind == "train"

    # serving steps run under inference mode, so their inputs are made
    # under it too (a view of a normal tensor there is refused)
    with contextlib.nullcontext() if train else torch.inference_mode():
        batch_meta = abstract_batch(cfg, batch=B, seq=S, kind=kind)
        b_specs = rules.batch_specs(batch_meta, mesh)
        batch = {k: _place(v, b_specs[k], mesh)
                 for k, v in batch_meta.items()}
        model = _sharded_model(cfg, tdtype, mesh, fsdp=fsdp,
                               attn_ms=attn_ms, train=train)
        if train:
            specs = rules.param_specs(model, mesh, fsdp=fsdp,
                                      attn_model_shard=attn_ms)
            state = _train_state(model, mesh, specs)
            step = make_train_step(cfg, ep_ctx=_mesh_ep(mesh, cfg, moe_cap),
                                   chunked_ce=chunked_ce,
                                   act_sharding=act_sharding,
                                   layer_remat=layer_remat)
            args = (state, batch)
        else:
            cache = _cache(cfg, B, S, tdtype, mesh, ring_kv)
            if kind == "prefill":
                ep_ctx = _mesh_ep(mesh, cfg, moe_cap)

                @torch.inference_mode()
                def step(params, batch, cache):
                    logits, new_cache, _ = transformer.forward(
                        params, cfg, batch, cache=cache, ep_ctx=ep_ctx,
                        act_sharding=act_sharding,
                        attn_seq_sharding=attn_seq_sharding)
                    return logits, new_cache
                args = (model, batch, cache)
            else:
                def step(params, tokens, pos, cache):
                    return serve_mod.decode_step(params, cfg, tokens, pos,
                                                 cache)
                args = (model, batch["tokens"], batch["pos"], cache)
    return Lowered(step=step, args=args, dtype=dtype, fsdp=fsdp,
                   argument_bytes=_local_bytes(args))


def one_device_cost(cfg, kind: str, B: int, S: int, *,
                    device_type: str = "cuda", **kw):
    """The :class:`~repro_torch.roofline.hlo_cost.Cost` of one step on a
    one-device (1, 1) mesh of a fake group of one rank: what the same
    step run for real on one card counts (``launch/zoo_train_check.py``
    holds the two equal)."""
    with fake_world(1):
        mesh = init_device_mesh(device_type, (1, 1),
                                mesh_dim_names=("data", "model"))
        lowered = lower_step(cfg, kind, B, S, mesh, fsdp=False, **kw)
        return _run(lowered)[0]


def lower_lda(shape_name: str, W: int, *, topics: int = 1024) -> tuple:
    """The paper's workload at the reference's shapes (``W`` workers, B =
    W blocks, L = max(64, tokens // W²) slots a cell, I_max = 1024 docs
    and J_max = 64 words a shard, T topics), as the port runs it: all W
    workers' sweep on one card, bounded by the fused kernel's model.
    Returns (the report's numbers, note); nothing is traced."""
    spec = INPUT_SHAPES[shape_name]
    n_tokens = spec["global_batch"] * spec["seq_len"]
    L = max(64, n_tokens // (W * W))
    I_max, J_max, T, B = 1024, 64, topics, W
    slots = W * B * L
    # the reference's arguments: tokens, doc ids, z (int32), two masks
    # (bool), n_td (W, I_max, T), n_wt (B, J_max, T), n_t (T,), the step
    arg_bytes = (3 * 4 + 2) * slots + 4 * (W * I_max * T + B * J_max * T
                                           + T + 1)
    # worst case: every slot valid, every row touched, every (cell, word)
    # pair a boundary
    nbytes, ops = sweep_work(valid=slots, bounds=min(slots, W * B * J_max),
                             slots=slots, docs=W * I_max, words=B * J_max,
                             cap=T, sparse=False, T=T)
    note = (f"nomad sweep of W={W} workers on one card, B={B}, L={L} a "
            f"cell, T={T}; {LDA_MODEL}")
    return {"flops": float(ops), "bytes": float(nbytes),
            "argument_bytes": arg_bytes}, note


# ---------------------------------------------------------------------------
# Report.
# ---------------------------------------------------------------------------
def _run(lowered: Lowered) -> tuple:
    """(the Cost of one run of the step, what it returned)."""
    outputs = []

    def run(*args):
        with implicit_replication():
            outputs.append(lowered.step(*args))
    return analyze_step(run, *lowered.args), outputs[0]


def analyse(lowered: Lowered, arch, shape_name, mesh_name, n_chips,
            note="") -> dict:
    """Run the lowered step once under ``analyze_step``; the report.
    Numbers are per device: what rank 0 runs on its shards."""
    t0 = time.perf_counter()
    cost, out = _run(lowered)
    trace_s = time.perf_counter() - t0
    coll = cost.collectives()
    terms = roofline_terms(cost.flops, cost.bytes, coll["total"],
                           dtype=lowered.dtype)
    mem = {"argument_bytes": lowered.argument_bytes,
           "output_bytes": _local_bytes(out),
           "peak_bytes": cost.peak_bytes}
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": n_chips, "note": note, "dtype": lowered.dtype,
        "fsdp": lowered.fsdp,
        "trace_seconds": round(trace_s, 1),
        "flops_per_device": cost.flops,
        "bytes_per_device": cost.bytes,
        "collective_bytes_per_device": coll,
        "memory": mem,
        "roofline_seconds": terms,
        "bottleneck": max(terms, key=terms.get),
        "fits": mem["peak_bytes"] <= HW.HBM_BYTES,
    }


def lda_report(shape_name: str, W: int, mesh_name: str, *,
               topics: int = 1024) -> dict:
    """The LDA combo's report, in the keys of :func:`analyse`."""
    nums, note = lower_lda(shape_name, W, topics=topics)
    terms = roofline_terms(nums["flops"], nums["bytes"], 0.0, dtype="f32")
    coll = {k: 0 for k in ("all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all", "collective-permute")}
    coll["total"] = 0
    coll["op_counts"] = {k: 0 for k in coll if k != "total"}
    mem = {"argument_bytes": nums["argument_bytes"],
           "output_bytes": nums["argument_bytes"],
           "peak_bytes": nums["argument_bytes"]}
    return {"arch": "lda-fnomad", "shape": shape_name, "mesh": mesh_name,
            "chips": 1, "workers": W, "note": note, "dtype": "f32",
            "trace_seconds": 0.0,
            "flops_per_device": nums["flops"],
            "bytes_per_device": nums["bytes"],
            "collective_bytes_per_device": coll, "memory": mem,
            "roofline_seconds": terms,
            "bottleneck": max(terms, key=terms.get),
            "fits": mem["peak_bytes"] <= HW.HBM_BYTES}


def dry_run(arch, shape_name: str, mesh, mesh_name: str, **kw) -> dict:
    """One combo's report: ``skipped``, ``error`` (with the trace's
    tail), or :func:`analyse`'s."""
    name = arch if isinstance(arch, str) else arch.name
    try:
        lowered, note = lower_arch(arch, shape_name, mesh, **kw)
        if lowered is None:
            return {"arch": name, "shape": shape_name, "mesh": mesh_name,
                    "skipped": note}
        return analyse(lowered, name, shape_name, mesh_name, mesh.size(),
                       note)
    except Exception as e:  # noqa: BLE001 - a combo's failure is reported
        return {"arch": name, "shape": shape_name, "mesh": mesh_name,
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-4000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all", help="arch id | all | lda")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the mesh's device type (the shards are meta "
                         "tensors either way)")
    ap.add_argument("--dtype", default="f32", choices=sorted(DTYPES),
                    help="param/activation dtype (§Perf mixed precision)")
    ap.add_argument("--chunked-ce", action="store_true",
                    help="§Perf: never materialize (B,S,V) logits")
    ap.add_argument("--act-shard", action="store_true",
                    help="§Perf: pin layer activations to batch sharding")
    ap.add_argument("--ring-kv", action="store_true",
                    help="§Perf: window-sized ring KV cache (SW archs)")
    ap.add_argument("--layer-remat", action="store_true",
                    help="§Perf: per-layer remat (layer inputs only)")
    ap.add_argument("--attn-replicate", action="store_true",
                    help="§Perf: replicate attention weights (heads "
                         "indivisible by the model axis)")
    ap.add_argument("--attn-seq-shard", action="store_true",
                    help="§Perf: context parallelism, S over 'model' for "
                         "attention (prefill)")
    ap.add_argument("--moe-cap", type=float, default=1.25,
                    help="§Perf: MoE expert capacity factor")
    ap.add_argument("--lda-topics", type=int, default=1024,
                    help="T for the LDA dry-run (paper scaling axis)")
    ap.add_argument("--tag", default="",
                    help="suffix for report filenames (perf variants)")
    args = ap.parse_args(argv)

    out_dir = args.out or REPORTS
    os.makedirs(out_dir, exist_ok=True)
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    errors = 0

    if args.arch == "lda":
        W = 512 if args.multi_pod else 256
        mesh_name = f"lda-{W}"
        for shape_name in shapes:
            try:
                rep = lda_report(shape_name, W, mesh_name,
                                 topics=args.lda_topics)
                rep["variant"] = args.tag or "baseline"
            except Exception as e:  # noqa: BLE001
                rep = {"arch": "lda-fnomad", "shape": shape_name,
                       "mesh": mesh_name, "error": f"{type(e).__name__}: "
                       f"{e}", "trace": traceback.format_exc()[-4000:]}
            errors += "error" in rep
            _write(out_dir, f"lda__{shape_name}__{mesh_name}", args.tag,
                   rep)
        return 1 if errors else 0

    n = 512 if args.multi_pod else 256
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=args.device)
        for arch in archs:
            for shape_name in shapes:
                rep = dry_run(arch, shape_name, mesh, mesh_name,
                              dtype=args.dtype, chunked_ce=args.chunked_ce,
                              act_shard=args.act_shard,
                              ring_kv=args.ring_kv,
                              layer_remat=args.layer_remat,
                              attn_replicate=args.attn_replicate,
                              attn_seq_shard=args.attn_seq_shard,
                              moe_cap=args.moe_cap)
                if "error" not in rep and "skipped" not in rep:
                    rep["variant"] = args.tag or "baseline"
                errors += "error" in rep
                _write(out_dir, f"{arch}__{shape_name}__{mesh_name}",
                       args.tag, rep)
    return 1 if errors else 0


def _write(out_dir, tag, variant, rep):
    if variant:
        tag += "__" + variant
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rep, f, indent=1)
    status = ("ERROR " + rep["error"][:120]) if "error" in rep else \
        ("SKIP " + rep.get("skipped", "")) if "skipped" in rep else \
        (f"ok trace={rep['trace_seconds']}s "
         f"bottleneck={rep['bottleneck']} fits={rep['fits']}")
    print(f"[dryrun] {tag}: {status}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
