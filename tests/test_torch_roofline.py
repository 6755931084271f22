"""The port's roofline (``repro_torch/roofline``) and dry-run
(``repro_torch/launch/dryrun.py``) against the reference's
(``repro/roofline``, ``repro/launch/dryrun.py``).

``analyze_step`` counts the ops a step runs, per device: on a DTensor
program it counts the local shards' ops, not the global op.  On one
device the forward's product flops equal the reference's ``analyze_hlo``
of the jitted forward, arch by arch, except where the two count
different ops; those ops are named here and their flops are the whole
difference.  The dry-run itself runs on fake 256- and 512-rank groups in
subprocesses.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jtransformer
from repro.roofline.analysis import model_flops as j_model_flops
from repro.roofline.hlo_cost import analyze_hlo

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import sharding_rules as rules
from repro_torch.launch.mesh import HW, fake_world, make_production_mesh
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer
from repro_torch.roofline import analysis
from repro_torch.roofline.hlo_cost import CostMode, analyze_step
from repro_torch.train.train_step import make_train_step, train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ analyze_step
def test_plain_matmul():
    N = 128
    a = torch.zeros(N, N)
    assert analyze_step(lambda: a @ a).flops == 2 * N ** 3


def test_python_loop_counts_every_product():
    """The reference scales a scan body by its trip count; here the loop
    simply runs L times."""
    N, L = 64, 12
    w = torch.zeros(L, N, N)

    def f(x):
        for i in range(L):
            x = x @ w[i]
        return x.sum()
    assert analyze_step(f, torch.zeros(N, N)).flops == L * 2 * N ** 3


@pytest.mark.parametrize("inference", [False, True])
def test_batched_einsum(inference):
    """Under inference mode ``einsum`` reaches the mode whole and is
    decomposed there; the count is the same."""
    B, M, K, N = 4, 32, 64, 16
    a, b = torch.zeros(B, M, K), torch.zeros(B, K, N)

    def f():
        with torch.inference_mode(inference):
            return torch.einsum("bmk,bkn->bmn", a, b)
    assert analyze_step(f).flops == 2 * B * M * K * N


def test_bytes_at_least_operands_and_result():
    N = 256
    a = torch.zeros(N, N)
    c = analyze_step(lambda: a @ a)
    assert c.bytes >= 3 * N * N * 4


def test_views_free_gathers_and_updates_touched():
    x, ones = torch.zeros(64, 32), torch.ones(8, 32)
    idx = torch.arange(8)
    assert analyze_step(lambda: (x.view(-1)[:10], x.T, x.expand(2, 64, 32))
                        ).bytes == 0
    assert analyze_step(lambda: x[idx]).bytes == 2 * 8 * 32 * 4
    assert analyze_step(lambda: x.index_put_((idx,), ones)).bytes == \
        2 * 8 * 32 * 4


def test_hand_sharded_matmul_counts_the_local_shard():
    """x (256, 4096) sharded 256 ways over rows times a replicated
    (4096, 4096): the global op is 2·256·4096², a device's is 1/256 of
    it.  Sharding the weight's columns over 'model' instead divides by
    16 and needs no collective for the product."""
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        x = rules.with_sharding(torch.empty(256, 4096, device="meta"),
                                rules.P(("data", "model"), None), mesh)
        w = rules.with_sharding(torch.empty(4096, 4096, device="meta"),
                                rules.P(), mesh)
        c = analyze_step(lambda: x @ w)
        assert c.flops == 2 * 1 * 4096 * 4096
        x2 = rules.with_sharding(torch.empty(256, 4096, device="meta"),
                                 rules.P("data", None), mesh)
        w2 = rules.with_sharding(torch.empty(4096, 4096, device="meta"),
                                 rules.P(None, "model"), mesh)
        c2 = analyze_step(lambda: x2 @ w2)
        assert c2.flops == 2 * 16 * 4096 * 256
        assert c2.collective_bytes == 0
        # a replicated result needs the shards gathered: counted by kind
        c3 = analyze_step(lambda: (x2 @ w2).full_tensor())
        assert c3.collective_by_kind["all-gather"] > 0
        assert c3.collectives()["op_counts"]["all-gather"] >= 1


# --------------------------------------------- the forward against the HLO
B_FWD, S_FWD = 2, 64


def _batch(cfg):
    r = np.random.default_rng(0)
    if cfg.modality == "audio_frames":
        return {"frames": r.standard_normal(
            (B_FWD, S_FWD, cfg.frontend_dim)).astype(np.float32)}
    if cfg.modality == "image_patches":
        n = cfg.frontend_tokens
        return {"tokens": r.integers(0, cfg.vocab_size,
                                     (B_FWD, S_FWD - n)).astype(np.int32),
                "patches": r.standard_normal(
                    (B_FWD, n, cfg.frontend_dim)).astype(np.float32)}
    return {"tokens": r.integers(0, cfg.vocab_size,
                                 (B_FWD, S_FWD)).astype(np.int32)}


def _reference_flops(arch, batch):
    cfg = j_get_config(arch + "-smoke")
    params = jax.eval_shape(
        lambda: jtransformer.init_params(cfg, jax.random.key(0)))
    sds = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
           for k, v in batch.items()}
    txt = jax.jit(lambda p, b: jtransformer.forward(p, cfg, b)[0]).lower(
        params, sds).compile().as_text()
    return analyze_hlo(txt).flops


class _Tagged(CostMode):
    """Flops of the products run while ``tag`` is set, by tag."""
    tag = None

    def __init__(self):
        super().__init__()
        self.by_tag: dict = {}

    def _count(self, func, args, kwargs, out):
        before = self.cost.flops
        super()._count(func, args, kwargs, out)
        if self.tag is not None:
            self.by_tag[self.tag] = self.by_tag.get(self.tag, 0.0) + \
                self.cost.flops - before


def _port_forward(arch, batch, monkeypatch):
    cfg = get_config(arch + "-smoke")
    model = transformer.init_params(cfg, 0, device="cpu")
    mode = _Tagged()

    def tagging(fn, tag, when=lambda *a, **k: True):
        def run(*a, **k):
            if not when(*a, **k):
                return fn(*a, **k)
            mode.tag = tag
            try:
                return fn(*a, **k)
            finally:
                mode.tag = None
        return run
    # the SSD's state update, bjh,bjhp,bjn->bhpn (models/ssm.py)
    monkeypatch.setattr(torch, "einsum", tagging(
        torch.einsum, "ssd_state_update",
        lambda eq, *a: eq == "bjh,bjhp,bjn->bhpn"))
    # zamba2's shared attention block (models/transformer.py)
    monkeypatch.setattr(transformer, "_shared_apply", tagging(
        transformer._shared_apply, "shared_block"))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with mode:
        transformer.forward(model, cfg, tb)
    monkeypatch.undo()
    return mode.cost.flops, mode.by_tag, cfg, model


# The ops the two counters count differently, by arch:
# * ssd_state_update: XLA CPU computes the chunked SSD's state update
#   einsum without a ``dot`` (no product for analyze_hlo to count); the
#   port runs it as a ``bmm``.
# * shared_block: the reference applies zamba2's shared attention block
#   under ``lax.cond``, and analyze_hlo does not descend into a
#   ``conditional``'s ``branch_computations``, so it counts the block's
#   products as 0; the port runs the block where it applies.
DIFFERING = {"mamba2-1.3b": ("ssd_state_update",),
             "zamba2-2.7b": ("ssd_state_update", "shared_block")}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_flops_against_reference(arch, monkeypatch):
    batch = _batch(get_config(arch + "-smoke"))
    want = _reference_flops(arch, batch)
    got, by_tag, cfg, _ = _port_forward(arch, batch, monkeypatch)
    tags = DIFFERING.get(arch, ())
    assert set(k for k, v in by_tag.items() if v) == set(tags)
    assert got - sum(by_tag[t] for t in tags) == want
    if "ssd_state_update" in tags:
        # 2·B·H·P·N·Q a chunk, one chunk a layer at S = 64
        per = 2 * B_FWD * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state \
            * S_FWD
        assert by_tag["ssd_state_update"] == per * cfg.num_layers


def test_forward_matches_analytic(monkeypatch):
    """Whole-model check: smoke forward ≈ 2·N·D, the reference's bound."""
    batch = _batch(get_config("granite-3-2b-smoke"))
    got, _, _, model = _port_forward("granite-3-2b", batch, monkeypatch)
    n = sum(p.numel() for p in model.parameters())
    est = 2 * n * B_FWD * S_FWD
    assert 0.8 < got / est < 1.4, (got, est)


# ----------------------------------------------------------------- analysis
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_reference(arch):
    for shape in INPUT_SHAPES:
        assert analysis.model_flops(arch, shape) == \
            j_model_flops(arch, shape)
    assert analysis.model_flops("lda-fnomad", "train_4k") == 0.0


def test_roofline_terms_of_the_h100():
    for dtype in ("f32", "bf16"):
        t = analysis.roofline_terms(HW.peak_flops(dtype), HW.HBM_BW,
                                    HW.LINK_BW, dtype=dtype)
        assert t == {"compute": 1.0, "memory": 1.0, "collective": 1.0}
    assert analysis.roofline_terms(67e12, 0, 0)["compute"] == 1.0


def test_sweep_bound_is_the_card_checks_model():
    """chip_smoke.py bounds the fused sweep by these numbers."""
    nbytes, ops = analysis.sweep_work(valid=100, bounds=10, slots=128,
                                      docs=4, words=3, cap=64, sparse=False,
                                      T=64)
    assert nbytes == 28 * 128 + 2 * 256 * 7
    assert ops == 100 * (64 + 192 + 14) + 10 * 192
    ms, by = analysis.sweep_bound(100, 10, 128, 4, 3, 64, False, 64)
    assert (ms, by) == analysis.bytes_ops_bound(nbytes, ops)
    assert by == "bytes" and ms == nbytes / 3.35e12 * 1e3


def test_build_table_reads_port_reports():
    rep = {"arch": "qwen3-8b", "shape": "train_4k", "mesh": "16x16",
           "chips": 256, "flops_per_device": 1e15, "bottleneck": "memory",
           "roofline_seconds": {"compute": 1.0, "memory": 2.0,
                                "collective": 0.5}}
    rows = analysis.build_table([rep, {"arch": "x", "shape": "y",
                                       "mesh": "16x16", "skipped": "no"}])
    assert rows[0][3] == "memory" and "useful=" in rows[0][4]
    assert rows[1][3] == "SKIP"


def test_lda_report():
    rep = dryrun.lda_report("train_4k", 256, "lda-256")
    W, L, T = 256, 64, 1024
    slots = W * W * L
    assert rep["memory"]["argument_bytes"] == 14 * slots + 4 * (
        W * 1024 * T + W * 64 * T + T + 1)
    assert rep["collective_bytes_per_device"]["total"] == 0
    assert rep["roofline_seconds"]["collective"] == 0
    assert rep["fits"] and "not traced" in rep["note"]


def test_one_device_dry_run_counts_the_real_step():
    """The dry-run's step on a one-device mesh counts what the same step
    counts run for real (here on the CPU; chip_smoke.py holds the two
    equal on the card at full size)."""
    cfg = get_config("granite-3-2b-smoke")
    B, S = 2, 128
    kw = dict(layer_remat=True, chunked_ce=True)
    state = train_state(transformer.init_params(cfg, 0, device="cpu"))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     dtype=torch.int32)}
    real = analyze_step(make_train_step(cfg, **kw), state, batch)
    dry = dryrun.one_device_cost(cfg, "train", B, S, device_type="cpu",
                                 **kw)
    assert real.flops == dry.flops > 0


def test_ssd_einsum_is_the_tagged_one():
    """The equation the forward test names is the SSD's state update."""
    import inspect
    assert "bjh,bjhp,bjn->bhpn" in inspect.getsource(ssm_mod._ssd_chunked)


# ------------------------------------------------------- the dry-run itself
GQA = "granite-3-2b-gqa"
DRY_COMBOS = [(arch, shape)
              for arch in ("granite-3-2b", "deepseek-moe-16b", "mamba2-1.3b",
                           GQA)
              for shape in ("train_4k", "prefill_32k", "decode_32k")]

# One fake world a process.  Smoke-size archs (deepseek's with 16
# experts, so they split over the 16-way model axis and the MoE layers
# run expert-parallel; GQA's granite with 32 query and 8 kv heads, the
# full-size layout, whose heads split over it); a mesh of "1" is the
# one-device count.
_DRY = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.roofline.hlo_cost import tensors_of
mesh_name, combos = sys.argv[1], json.loads(sys.argv[2])
out = {}

def cfg_of(arch):
    if arch == "%s":
        return dataclasses.replace(get_config("granite-3-2b-smoke"),
                                   num_heads=32, num_kv_heads=8, head_dim=8)
    cfg = get_config(arch + "-smoke")
    return dataclasses.replace(cfg, num_experts=16) if cfg.num_experts \
        else cfg

if mesh_name == "1":
    for arch, shape in combos:
        spec = INPUT_SHAPES[shape]
        c = dryrun.one_device_cost(cfg_of(arch), spec["kind"],
                                   spec["global_batch"], spec["seq_len"],
                                   device_type="cpu")
        out[f"{arch}|{shape}"] = {"flops_per_device": c.flops}
else:
    multi = mesh_name == "2x16x16"
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        for arch, shape in combos:
            cfg = cfg_of(arch)
            rep = dryrun.dry_run(cfg, shape, mesh, mesh_name)
            lowered, _ = dryrun.lower_arch(cfg, shape, mesh)
            shards = 0
            for t in tensors_of(lowered.args):
                n = t.numel() * t.element_size()
                for i, p in enumerate(getattr(t, "placements", ())):
                    if p.is_shard():
                        n //= mesh.size(i)
                shards += n
            rep["shard_bytes"] = shards
            rep["has_ep"] = bool(cfg.num_experts)
            out[f"{arch}|{shape}"] = rep
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def dry_reports():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = {m: subprocess.Popen(
        [sys.executable, "-c", _DRY % GQA, m, json.dumps(DRY_COMBOS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for m in ("16x16", "2x16x16", "1")}
    out = {}
    for m, p in procs.items():
        stdout, stderr = p.communicate(timeout=900)
        assert p.returncode == 0, stderr[-3000:]
        out[m] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", DRY_COMBOS)
def test_dry_run_smoke(dry_reports, mesh, arch, shape):
    rep = dry_reports[mesh][f"{arch}|{shape}"]
    assert "error" not in rep, rep.get("trace")
    chips = 512 if mesh == "2x16x16" else 256
    assert rep["chips"] == chips and rep["mesh"] == mesh
    total = dry_reports["1"][f"{arch}|{shape}"]["flops_per_device"]
    # every product is split over the devices, or repeated at most over
    # the 16-way model axis (attention whose 4 heads do not split)
    assert total <= rep["flops_per_device"] * chips <= 16 * total
    if arch == GQA:
        # heads that split: attention and every product split exactly,
        # the backward's too (no weight gathered for a partial gradient)
        assert rep["flops_per_device"] * chips == total
    coll = rep["collective_bytes_per_device"]
    assert coll["total"] > 0
    assert coll["total"] == sum(coll[k] for k in (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"))
    if rep["has_ep"] and shape != "decode_32k":
        assert coll["op_counts"]["all-to-all"] > 0     # the EP exchanges
    assert rep["memory"]["argument_bytes"] == rep["shard_bytes"]
    assert rep["memory"]["peak_bytes"] >= rep["memory"]["argument_bytes"]
    assert rep["bottleneck"] in rep["roofline_seconds"]
    t = rep["roofline_seconds"]
    assert t["compute"] == rep["flops_per_device"] / HW.PEAK_FLOPS_F32
    assert rep["dtype"] == "f32" and rep["fits"] is True
