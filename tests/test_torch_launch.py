"""The port's dry-run launch layer (``repro_torch/launch/input_specs.py``,
``mesh.py``, ``sharding_rules.py``) against the reference's
(``repro/launch``).

Specs are compared entry by entry: a port parameter of a stacked segment
has the reference's spec without its leading layer entry.  The shard
shapes on the real 16×16 and 2×16×16 meshes come from one subprocess that
fakes 512 XLA CPU devices (``NamedSharding.shard_shape``, no compile); the
port's come from DTensors on a fake process group (``fake_world``, always
closed again).
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import shape_applicable as j_shape_applicable
from repro.launch import sharding_rules as jrules
from repro.launch.input_specs import input_specs as j_input_specs
from repro.models import transformer as jtransformer
from repro.train.train_step import init_train_state as j_init_train_state

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, \
    shape_applicable
from repro_torch.launch import sharding_rules as rules
from repro_torch.launch.input_specs import input_specs
from repro_torch.launch.mesh import (HW, fake_world, make_lda_mesh,
                                     make_production_mesh)
from repro_torch.models import transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32}


class _Shim:
    """An axis-size-only mesh for both packages' spec logic (the
    reference reads ``axis_names`` and ``shape`` as a dict, the port
    ``mesh_dim_names`` and ``shape`` as a tuple)."""

    def __init__(self, sizes: dict):
        self.axis_names = self.mesh_dim_names = tuple(sizes)
        self._sizes = sizes

    @property
    def shape(self):
        return _Sizes(self._sizes)


class _Sizes(tuple):
    def __new__(cls, sizes):
        out = super().__new__(cls, tuple(sizes.values()))
        out.sizes = sizes
        return out

    def __getitem__(self, k):
        return self.sizes[k] if isinstance(k, str) else super().__getitem__(k)


POD = _Shim({"data": 16, "model": 16})
PODS = _Shim({"pod": 2, "data": 16, "model": 16})


def _p(spec) -> tuple:
    return tuple(spec)


def _jpath(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _j_leaves(tree) -> dict:
    return {_jpath(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def _meta_model(cfg):
    return transformer.Transformer(cfg, torch.Generator(), torch.float32,
                                   torch.device("meta"))


_J_PARAMS: dict = {}


def _j_params(arch):
    if arch not in _J_PARAMS:
        cfg = j_get_config(arch)
        _J_PARAMS[arch] = jax.eval_shape(
            lambda: jtransformer.init_params(cfg, jax.random.key(0)))
    return _J_PARAMS[arch]


# ------------------------------------------------------------- input specs
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_input_specs_match_reference(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert shape_applicable(cfg, shape) == j_shape_applicable(jcfg, shape)
    got, want = input_specs(cfg, shape), j_input_specs(jcfg, shape)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == DTYPES[w.dtype.type], k
        assert got[k].device.type == "meta"


def test_vlm_patches_and_text_fill_the_sequence():
    cfg = get_config("internvl2-1b")
    got = input_specs(cfg, "prefill_32k")
    total = got["tokens"].shape[1] + got["patches"].shape[1]
    assert total == INPUT_SHAPES["prefill_32k"]["seq_len"]


def test_shapes_are_the_references():
    assert INPUT_SHAPES == J_SHAPES
    assert sorted(ARCHS) == sorted(J_ARCHS)


# ----------------------------------------------------------- sanitize_spec
@pytest.mark.parametrize("spec,shape", [
    (("model", None), (151655, 896)),
    (("model", None), (163840, 7168)),
    ((("data", "model"), None), (512, 4)),
    ((("data", "model"), None), (100, 4)),
    (("model",), (32, 4, 4)),
])
def test_sanitize_spec_reference_cases(spec, shape):
    want = jrules.sanitize_spec(JP(*spec), shape, POD)
    got = rules.sanitize_spec(rules.P(*spec), shape, POD)
    assert _p(got) == _p(want)


_AXES = [None, "pod", "data", "model", ("pod", "data"), ("data", "model"),
         ("pod", "data", "model")]


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_sanitize_spec_random(seed):
    r = np.random.default_rng(seed)
    ndim = int(r.integers(1, 5))
    spec = [_AXES[i] for i in r.integers(0, len(_AXES), int(
        r.integers(0, ndim + 1)))]
    shape = tuple(int(d) for d in r.choice(
        [1, 2, 3, 4, 8, 14, 16, 32, 48, 100, 256, 512, 151655], ndim))
    want = jrules.sanitize_spec(JP(*spec), shape, PODS)
    got = rules.sanitize_spec(rules.P(*spec), shape, PODS)
    assert _p(got) == _p(want)


# ------------------------------------------------------------- param specs
def _assert_params_match(model, jspecs, port_specs):
    want = _j_leaves(jspecs)
    seen = set()
    for name, spec in port_specs.items():
        path, stacked = rules.reference_path(name)
        ref = _p(want[path])
        assert _p(spec) == (ref[1:] if stacked else ref), (name, spec, ref)
        if stacked:
            assert ref[0] is None, name
        seen.add(path)
    assert seen == set(want)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("attn_ms", [True, False])
def test_param_specs_match_reference(arch, fsdp, attn_ms):
    jspecs = jrules.param_specs(_j_params(arch), POD, fsdp=fsdp,
                                attn_model_shard=attn_ms)
    model = _meta_model(get_config(arch))
    got = rules.param_specs(model, POD, fsdp=fsdp, attn_model_shard=attn_ms)
    assert set(got) == {k for k, _ in model.named_parameters()}
    _assert_params_match(model, jspecs, got)


def test_expert_weights_read_as_experts():
    """The port's expert weight (E, d, f) has rank 3, as a stacked dense
    MLP has in the reference: classified by its reference rank, it shards
    E over 'model'."""
    got = rules.param_specs(_meta_model(get_config("deepseek-moe-16b")),
                            POD)
    assert got["segments.1.0.mlp.w_gate"] == rules.P("model", None, None)
    assert got["segments.1.0.mlp.router"] == rules.P(None, "model")
    assert got["segments.0.0.mlp.w_gate"] == rules.P(None, "model")


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("B", [128, 8])
@pytest.mark.parametrize("mesh", [POD, PODS], ids=["16x16", "2x16x16"])
def test_cache_specs_match_reference(arch, B, mesh):
    """decode_32k's batch, and one that does not divide the batch axes
    (the sequence axis takes them)."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    S = INPUT_SHAPES["decode_32k"]["seq_len"]
    want = jrules.cache_specs(jax.eval_shape(
        lambda: jtransformer.init_cache(jcfg, B, S)), mesh)
    got = rules.cache_specs(transformer.init_cache(cfg, B, S,
                                                   device="meta"), mesh)
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}/")
        else:
            flat[prefix[:-1]] = _p(tree)
    walk(got, "")
    assert flat == {k: _p(v) for k, v in _j_leaves(want).items()}


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-moe-16b"])
def test_train_state_specs_match_reference(arch):
    jcfg = j_get_config(arch)
    jstate = jax.eval_shape(
        lambda: j_init_train_state(jcfg, jax.random.key(0)))
    want = jrules.train_state_specs(jstate, POD, fsdp=True)
    model = _meta_model(get_config(arch))
    got = rules.train_state_specs(SimpleNamespace(params=model), POD,
                                  fsdp=True)
    assert _p(got["step"]) == _p(want.opt.step) == ()
    for key, jtree in (("params", want.params), ("m", want.opt.m),
                       ("v", want.opt.v)):
        _assert_params_match(model, jtree, got[key])


def test_batch_specs_shard_the_batch():
    cfg = get_config("internvl2-1b")
    batch = input_specs(cfg, "prefill_32k")
    got = rules.batch_specs(batch, PODS)
    want = jrules.batch_specs(j_input_specs(j_get_config("internvl2-1b"),
                                            "prefill_32k"), PODS)
    assert {k: _p(v) for k, v in got.items()} == \
        {k: _p(v) for k, v in _j_leaves(want).items()}


# ------------------------------------------------------------ placements
def test_to_placements_pod_major():
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        pl = rules.to_placements(rules.P(("pod", "data"), None, "model"),
                                 mesh)
        assert [str(p) for p in pl] == ["S(0)", "S(0)", "S(2)"]
        with pytest.raises(ValueError, match="order"):
            rules.to_placements(rules.P(("data", "pod")), mesh)
        t = rules.with_sharding(torch.empty(64, 3, 32, device="meta"),
                                rules.P(("pod", "data"), None, "model"),
                                mesh)
        assert tuple(t._local_tensor.shape) == (2, 3, 2)
        assert tuple(t.shape) == (64, 3, 32)
        # an axis that does not divide is dropped, never an uneven shard
        u = rules.with_sharding(torch.empty(100, 3, device="meta"),
                                rules.P(("pod", "data"), "model"), mesh)
        assert tuple(u._local_tensor.shape) == (100, 3)


def test_meshes_and_fake_world_close():
    import torch.distributed as dist
    with fake_world(256):
        m = make_production_mesh(device_type="cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert tuple(m.shape) == (16, 16)
        lda = make_lda_mesh(device_type="cpu")
        assert lda.mesh_dim_names == ("worker",) and lda.size() == 256
        with pytest.raises(RuntimeError, match="needs a world of 512"):
            make_production_mesh(multi_pod=True, device_type="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with fake_world(512):
            m = make_lda_mesh(multi_pod=True, device_type="cpu")
            assert m.mesh_dim_names == ("pod", "worker")
            1 / 0
    assert not dist.is_initialized()


def test_hw_is_the_h100():
    assert HW.CARD == "NVIDIA H100 80GB HBM3" and HW.POWER_LIMIT_W == 700
    assert HW.HBM_BW == 3.35e12 and HW.HBM_BYTES == 80e9
    assert HW.peak_flops("f32") == 67e12
    assert HW.peak_flops("bf16") == 989e12
    assert HW.LINK_BW == 50e9


# ---------------------------------------------------- shard shapes, full size
SHARD_ARCHS = {"qwen3-8b": False, "deepseek-moe-16b": False,
               "kimi-k2-1t-a32b": True}

# Runs in a fresh interpreter: the device count must be set before jax
# is imported.  Shapes only: eval_shape and NamedSharding.shard_shape.
_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.launch import sharding_rules as rules
from repro.launch.mesh import make_production_mesh
from repro.models import transformer
out = {}
for multi_pod in (False, True):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for arch, fsdp in json.loads(sys.argv[1]).items():
        cfg = get_config(arch)
        shapes = jax.eval_shape(
            lambda: transformer.init_params(cfg, jax.random.key(0)))
        specs = rules.param_specs(shapes, mesh, fsdp=fsdp)
        def one(path, leaf, spec):
            s = rules.sanitize_spec(spec, leaf.shape, mesh)
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            out[f"{int(multi_pod)}|{arch}|{key}"] = list(
                NamedSharding(mesh, s).shard_shape(leaf.shape))
        jax.tree_util.tree_map_with_path(one, shapes, specs)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_shards():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps(SHARD_ARCHS)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_local_shard_shapes_match_reference(reference_shards, multi_pod):
    n = 0
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        for arch, fsdp in SHARD_ARCHS.items():
            model = _meta_model(get_config(arch))
            specs = rules.param_specs(model, mesh, fsdp=fsdp)
            for name, p in model.named_parameters():
                path, stacked = rules.reference_path(name)
                want = reference_shards[f"{int(multi_pod)}|{arch}|{path}"]
                got = rules.with_sharding(p, specs[name], mesh)
                assert list(got._local_tensor.shape) == \
                    (want[1:] if stacked else want), (arch, name)
                n += 1
    assert n > 1000
