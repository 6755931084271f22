"""The zoo's building blocks in the port (``repro_torch/models``) against
the JAX reference (``repro/models``) on the CPU.

Inputs are drawn with numpy from a seed and weights are carried across
with ``repro_torch.convert.load_module``.  Float outputs agree within
``TOL`` = 1e-4 of the largest |value| of the reference's output (the two
packages' f32 matrix products reduce in different orders); integer
outputs (``dispatch_indices``, the chosen experts) are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.convert import load_module
from repro_torch.models import attention, layers, moe, ssm

TOL = 1e-4


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, f"max |diff| {err:.3g} > {tol} × {scale:.3g}"


def _np(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("pos_2d", [False, True])
def test_rope(theta, pos_2d):
    r = np.random.default_rng(1)
    x = _np(r, 2, 9, 3, 32)
    pos = np.arange(9, dtype=np.int32) + 5
    if pos_2d:
        pos = np.stack([pos, pos * 3])
    want = ref_attn.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(attention.rope(_t(x), _t(pos), theta), want)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rmsnorm(eps):
    r = np.random.default_rng(2)
    x, s = _np(r, 3, 5, 64, scale=4.0), _np(r, 64, scale=0.3)
    want = ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(s), eps)
    _close(layers.rmsnorm(_t(x), _t(s), eps), want)


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap(cap):
    x = np.linspace(-200, 200, 4001, dtype=np.float32)
    _close(layers.softcap(_t(x), cap),
           ref_layers.softcap(jnp.asarray(x), cap))


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp(activation):
    r = np.random.default_rng(3)
    p = ref_layers.mlp_init(jax.random.key(3), 48, 96, activation)
    mod = load_module(layers.MLP(torch.Generator().manual_seed(0), 48, 96,
                                 activation, torch.float32, "cpu"), _tree(p))
    x = _np(r, 2, 7, 48)
    _close(layers.mlp_forward(mod, _t(x), activation),
           ref_layers.mlp_forward(p, jnp.asarray(x), activation))


# ------------------------------------------------------------- attention
def _sdpa_case(r, B, Sq, Sk, Hq, Hkv, D):
    return _np(r, B, Sq, Hq, D), _np(r, B, Sk, Hkv, D), _np(r, B, Sk, Hkv, D)


SDPA_CASES = {
    # name: (B, Sq, Sk, Hq, Hkv, D, kwargs)
    "causal_gqa": (2, 16, 16, 4, 2, 16, dict(causal=True, window=0)),
    "causal_mha": (1, 12, 12, 3, 3, 8, dict(causal=True, window=0)),
    "window": (2, 24, 24, 4, 1, 16, dict(causal=True, window=5)),
    "encoder": (2, 10, 10, 4, 2, 8, dict(causal=False, window=0)),
    "softcap": (2, 16, 16, 4, 2, 16, dict(causal=True, window=0,
                                         logit_cap=0.5)),
    "chunked_2048": (1, 2048, 2048, 2, 1, 16, dict(causal=True, window=300)),
}


@pytest.mark.parametrize("name", sorted(SDPA_CASES))
def test_sdpa(name):
    B, Sq, Sk, Hq, Hkv, D, kw = SDPA_CASES[name]
    kw = dict(dict(q_offset=0, logit_cap=0.0), **kw)
    r = np.random.default_rng(len(name))
    q, k, v = _sdpa_case(r, B, Sq, Sk, Hq, Hkv, D)
    ref_kw = dict(kw, q_offset=jnp.asarray(kw["q_offset"]),
                  window=jnp.asarray(kw["window"], jnp.int32))
    want = ref_attn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          **ref_kw)
    _close(attention._sdpa(_t(q), _t(k), _t(v), **kw), want)


def test_sdpa_chunk_assertion():
    q = torch.zeros(1, 1500, 2, 8)
    with pytest.raises(AssertionError, match="query chunk"):
        attention._sdpa(q, q[:, :, :1], q[:, :, :1], causal=True, window=0,
                        q_offset=0, logit_cap=0.0)


@pytest.mark.parametrize("window", [0, 4])
def test_sdpa_kv_len(window):
    """A decode step against a preallocated cache: per-row lengths mask
    the rows past them."""
    r = np.random.default_rng(5)
    q, k, v = _sdpa_case(r, 3, 1, 16, 4, 2, 16)
    kv_len = np.array([1, 7, 16], np.int32)
    want = ref_attn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, window=jnp.asarray(window),
                          q_offset=jnp.asarray(kv_len - 1), logit_cap=0.0,
                          kv_len=jnp.asarray(kv_len))
    got = attention._sdpa(_t(q), _t(k), _t(v), causal=True, window=window,
                          q_offset=_t(kv_len - 1), logit_cap=0.0,
                          kv_len=_t(kv_len))
    _close(got, want)


def test_sdpa_kpos():
    """A ring cache's slots: absolute key positions out of order, some
    slots never written (-1)."""
    r = np.random.default_rng(6)
    q, k, v = _sdpa_case(r, 2, 1, 8, 4, 2, 16)
    kpos = np.array([[8, 9, 10, 3, 4, 5, 6, 7], [0, 1, 2, -1, -1, -1, -1,
                                                 -1]], np.int32)
    qpos = np.array([10, 2], np.int32)
    for window in (0, 6):
        want = ref_attn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=jnp.asarray(window),
                              q_offset=jnp.asarray(qpos), logit_cap=0.0,
                              kpos=jnp.asarray(kpos))
        got = attention._sdpa(_t(q), _t(k), _t(v), causal=True,
                              window=window, q_offset=_t(qpos),
                              logit_cap=0.0, kpos=_t(kpos))
        _close(got, want)


def test_attn_forward_linear_cache():
    """``attn_forward`` with qk-norm over a linear cache: a prompt then
    one step, outputs and the cache equal to the reference's."""
    cfg = get_config("qwen3-8b-smoke")
    p = ref_attn.attn_init(jax.random.key(7), ref_config("qwen3-8b-smoke"))
    mod = load_module(attention.Attention(torch.Generator().manual_seed(0),
                                          cfg, torch.float32, "cpu"),
                      _tree(p))
    r = np.random.default_rng(7)
    x = _np(r, 2, 6, cfg.d_model)
    jc = ref_attn.init_attn_cache(cfg, 2, 10)
    tc = attention.init_attn_cache(cfg, 2, 10, device="cpu")
    for sl, pos in ((slice(0, 5), np.zeros(2, np.int32)),
                    (slice(5, 6), np.full(2, 5, np.int32))):
        positions = pos[:, None] + np.arange(sl.stop - sl.start)[None, :]
        jy, jc = ref_attn.attn_forward(p, cfg, jnp.asarray(x[:, sl]),
                                       local=0, positions=jnp.asarray(
                                           positions), cache=jc)
        ty, tc = attention.attn_forward(mod, cfg, _t(x[:, sl]), local=0,
                                        positions=_t(positions), cache=tc)
        _close(ty, jy)
        _close(tc["k"], jc["k"])
        np.testing.assert_array_equal(tc["len"].numpy(), jc["len"])


# ------------------------------------------------------------------- ssm
def _ssd_inputs(r, B, S, H, P, N):
    dt = r.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    la = (-dt * r.uniform(0.1, 2.0, (1, 1, H))).astype(np.float32)
    return (_np(r, B, S, H, P), _np(r, B, S, N), _np(r, B, S, N), dt, la,
            _np(r, H), _np(r, B, H, P, N))


@pytest.mark.parametrize("S", [4, 64, 512])
def test_ssd_chunked(S):
    """One chunk, and at S = 512 two chunks with the state carried."""
    H, P, N = 3, 4, 5
    xh, Bm, Cm, dt, la, D, h0 = _ssd_inputs(np.random.default_rng(S), 2, S,
                                            H, P, N)
    wy, wh = ref_ssm._ssd_chunked(*map(jnp.asarray, (xh, Bm, Cm, dt, la, D)),
                                  H, P, N, jnp.asarray(h0))
    gy, gh = ssm._ssd_chunked(*map(_t, (xh, Bm, Cm, dt, la, D)), H, P, N,
                              _t(h0))
    _close(gy, wy)
    _close(gh, wh)


def test_ssd_chunk_assertion():
    xh, Bm, Cm, dt, la, D, h0 = _ssd_inputs(np.random.default_rng(0), 1,
                                            300, 2, 2, 2)
    with pytest.raises(AssertionError, match="SSD chunk"):
        ssm._ssd_chunked(*map(_t, (xh, Bm, Cm, dt, la, D)), 2, 2, 2, _t(h0))


def test_ssm_forward_cache_paths():
    """No cache over a prompt; then a cache-carrying prefill of 7 tokens
    and three one-token recurrence steps: outputs and the conv / ssm
    cache equal to the reference's."""
    cfg = get_config("mamba2-1.3b-smoke")
    p = ref_ssm.ssm_init(jax.random.key(8), ref_config("mamba2-1.3b-smoke"))
    mod = load_module(ssm.SSM(torch.Generator().manual_seed(0), cfg,
                              torch.float32, "cpu"), _tree(p))
    x = _np(np.random.default_rng(8), 2, 10, cfg.d_model)
    jy, _ = ref_ssm.ssm_forward(p, cfg, jnp.asarray(x))
    ty, _ = ssm.ssm_forward(mod, cfg, _t(x))
    _close(ty, jy)
    jc = ref_ssm.init_ssm_cache(cfg, 2)
    tc = ssm.init_ssm_cache(cfg, 2, device="cpu")
    for sl in (slice(0, 7), slice(7, 8), slice(8, 9), slice(9, 10)):
        jy, jc = ref_ssm.ssm_forward(p, cfg, jnp.asarray(x[:, sl]), jc)
        ty, tc = ssm.ssm_forward(mod, cfg, _t(x[:, sl]), tc)
        _close(ty, jy)
        _close(tc["ssm"], jc["ssm"])
        _close(tc["conv"], jc["conv"])


# ------------------------------------------------------------------- moe
def _dispatch_cases():
    r = np.random.default_rng(9)
    return {
        "random": (r.integers(0, 8, (40, 2)), 8, 8),
        "random_overflow": (r.integers(0, 4, (64, 3)), 4, 20),
        "all_same": (np.zeros((16, 1), np.int64), 4, 8),
        "all_same_pairs": (np.tile([[3, 1]], (12, 1)), 6, 8),
        "single": (np.array([[2]]), 3, 8),
    }


@pytest.mark.parametrize("name", sorted(_dispatch_cases()))
def test_dispatch_indices(name):
    experts, E, cap = _dispatch_cases()[name]
    experts = experts.astype(np.int32)
    want = ref_moe.dispatch_indices(jnp.asarray(experts), E, cap)
    got = moe.dispatch_indices(_t(experts), E, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if name.startswith("all_same") or name.endswith("overflow"):
        assert not np.asarray(want[2]).all()        # the case drops


def _moe_model():
    cfg = get_config("deepseek-moe-16b-smoke")
    p = ref_moe.moe_init(jax.random.key(10),
                         ref_config("deepseek-moe-16b-smoke"))
    mod = load_module(moe.MoE(torch.Generator().manual_seed(0), cfg,
                              torch.float32, "cpu"), _tree(p))
    return cfg, p, mod


@pytest.mark.parametrize("drops", [False, True])
def test_moe_forward(drops):
    """Random tokens, and tokens so alike that every one picks the same
    two experts: with 64 tokens and capacity 40 each of those drops 24
    choices.  The chosen experts and the dispatch are equal, y and the
    aux term within TOL."""
    cfg, p, mod = _moe_model()
    r = np.random.default_rng(11)
    x = _np(r, 4, 16, cfg.d_model)
    if drops:
        x = _np(r, 1, 1, cfg.d_model) + 1e-3 * x
    xf = x.reshape(-1, cfg.d_model)
    jw, je, jaux = ref_moe._router(p, cfg, jnp.asarray(xf))
    tw, te, taux = moe.route(mod, cfg, _t(xf))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tw, jw)
    _close(taux, jaux)
    cap = moe.capacity(xf.shape[0], cfg)
    assert cap == ref_moe._capacity(xf.shape[0], cfg, 1.25) == 40
    keep = np.asarray(ref_moe.dispatch_indices(je, cfg.num_experts, cap)[2])
    assert keep.all() != drops
    jy, jaux = ref_moe.moe_forward(p, cfg, jnp.asarray(x))
    ty, taux = moe.moe_forward(mod, cfg, _t(x))
    _close(ty, jy)
    _close(taux, jaux)
