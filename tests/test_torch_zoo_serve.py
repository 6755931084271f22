"""The zoo's serving path in the port (configs, ``models/transformer.py``,
``serve/serve_step.py``, ``serve/engine.py``) against the JAX reference,
for all ten archs at smoke size, on the CPU.

The reference's weights (``repro.models.transformer.init_params``, key 0)
are carried into the port with ``repro_torch.convert``.  Tolerances:

* logits, hidden caches: within ``TOL`` = 1e-4 of the largest |value| of
  the reference's tensor (the packages' f32 matrix products reduce in
  different orders);
* decode against the full forward: the reference's own 2e-3
  (``tests/test_archs_smoke.py``);
* cache lengths, ring slot positions, configs and counts: equal;
* generated tokens: equal at every step whose top-2 margin (of the
  logits, or of logits / T plus the step's Gumbel noise when sampling)
  exceeds twice the largest logit difference seen between the packages
  on the same inputs.  A row is compared up to its first step under that
  guard; the steps left uncompared are counted and printed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tf
from repro.serve import engine as ref_engine
from repro.serve import serve_step as ref_serve
from repro_torch import configs, convert, rng
from repro_torch.models import transformer
from repro_torch.serve import engine, serve_step

TOL = 1e-4
DECODE_TOL = 2e-3
ARCH_NAMES = sorted(ref_configs.ARCHS)
CAUSAL = [n for n in ARCH_NAMES if ref_configs.ARCHS[n].causal]
B, S = 2, 12
PROMPTS = [[5, 17, 3], [9, 1, 4, 1, 5, 9, 2], [42]]
NEW_TOKENS = 6


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, f"max |diff| {err:.3g} > {tol} × {scale:.3g}"


def _cache_equal(got: dict, want: dict):
    """Float leaves within TOL, integer leaves (len, slot_pos) equal."""
    gl = jax.tree_util.tree_leaves_with_path(convert.cache_to_reference(got))
    wl = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            _close(g, w)


@pytest.fixture(scope="module")
def models():
    """name -> (config, reference params, port model), built on first
    use and shared by the module's tests."""
    built = {}

    def get(name, cfg=None):
        if name not in built:
            cfg = cfg or ref_configs.get_config(name + "-smoke")
            jp = ref_tf.init_params(cfg, jax.random.key(0))
            tp = convert.params_from_reference(
                jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
            built[name] = (cfg, jp, tp)
        return built[name]
    return get


def _batch(cfg, seed=1, S=S):
    r = np.random.default_rng(seed)
    if cfg.modality == "audio_frames":
        return {"frames": r.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)}
    out = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.modality == "image_patches":
        out["patches"] = r.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_config_matches_reference(name):
    ref, got = ref_configs.ARCHS[name], configs.ARCHS[name]
    variants = [(ref, got), (ref.smoke(), got.smoke()),
                (ref.with_long_context(), got.with_long_context()),
                (ref_configs.get_config(name + "-smoke"),
                 configs.get_config(name + "-smoke"))]
    for r, g in variants:
        assert dataclasses.asdict(g) == dataclasses.asdict(r)
        assert g.layer_kinds() == r.layer_kinds()
        assert g.mlp_kinds() == r.mlp_kinds()
        assert g.param_count() == r.param_count()
        assert g.active_param_count() == r.active_param_count()
        assert (g.attention_free, g.d_inner, g.ssm_heads, g.sub_quadratic,
                g.is_encoder_only) == (r.attention_free, r.d_inner,
                                       r.ssm_heads, r.sub_quadratic,
                                       r.is_encoder_only)
        assert [dataclasses.astuple(s) for s in transformer.segments(g)] \
            == [dataclasses.astuple(s) for s in ref_tf.segments(r)]
    assert configs.INPUT_SHAPES == ref_configs.INPUT_SHAPES
    for shape in ref_configs.INPUT_SHAPES:
        assert configs.shape_applicable(got, shape) == \
            ref_configs.shape_applicable(ref, shape)


def test_registry_matches_reference():
    assert list(configs.ARCHS) == list(ref_configs.ARCHS)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_params_round_trip(name, models):
    """Reference → port → reference is the identity; the port's own init
    gives the reference's tree of names and shapes."""
    cfg, jp, tp = models(name)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = convert.params_to_reference(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    own = convert.params_to_reference(
        transformer.init_params(configs.get_config(name + "-smoke"), 0,
                                device="cpu"))
    assert jax.tree_util.tree_map(np.shape, own) == \
        jax.tree_util.tree_map(np.shape, tree)


# --------------------------------------------------------------- forward
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward(name, models):
    cfg, jp, tp = models(name)
    batch = _batch(cfg)
    jl, _, jaux = ref_tf.forward(jp, cfg, _j(batch))
    tl, _, taux = transformer.forward(tp, cfg, _t(batch))
    _close(tl, jl)
    _close(float(taux), float(jaux))
    jh, _, _ = ref_tf.forward(jp, cfg, _j(batch), return_hidden=True)
    th, _, _ = transformer.forward(tp, cfg, _t(batch), return_hidden=True)
    _close(th, jh)


@pytest.mark.parametrize("name", CAUSAL)
def test_prefill_then_decode(name, models):
    """Prefill S - 1 tokens (after the patches, for internvl), then decode
    one: logits and caches against the reference's after each, and the
    decoded logits against the port's own full forward."""
    cfg, jp, tp = models(name)
    batch = _batch(cfg, seed=2)
    S_pre = S - 1
    pre = dict(batch, tokens=batch["tokens"][:, :S_pre],
               pos=np.zeros(B, np.int32))
    n_front = cfg.frontend_tokens if "patches" in batch else 0
    S_max = n_front + S + 4
    jc = ref_serve.init_cache(cfg, B, S_max)
    tc = serve_step.init_cache(cfg, B, S_max, device="cpu")
    jl, jc = ref_serve.prefill(jp, cfg, _j(pre), jc)
    tl, tc = serve_step.prefill(tp, cfg, _t(pre), tc)
    _close(tl, jl)
    _cache_equal(tc, jc)
    pos = np.full(B, n_front + S_pre, np.int32)
    tok = batch["tokens"][:, S_pre:]
    jn, jd, jc = ref_serve.decode_step(jp, cfg, jnp.asarray(tok),
                                       jnp.asarray(pos), jc)
    tn, td, tc = serve_step.decode_step(tp, cfg, torch.as_tensor(tok),
                                        torch.as_tensor(pos), tc)
    _close(td, jd)
    _cache_equal(tc, jc)
    full, _, _ = transformer.forward(tp, cfg, _t(batch))
    _close(td[:, 0], full[:, -1], DECODE_TOL)
    step = serve_step.make_decode_step(cfg)
    _, again, _ = step(tp, torch.as_tensor(tok), torch.as_tensor(pos),
                       serve_step.init_cache(cfg, B, S_max, device="cpu"))
    assert again.shape == td.shape


# -------------------------------------------------------------- generate
def _reference_step_logits(jp, cfg, prompts, tokens, ring=False):
    """The reference engine's loop (``repro/serve/engine.py:generate``)
    with the port's tokens fed back: each step's last logits, (B, n, V)."""
    Bp, n = tokens.shape
    max_len = max(len(p) for p in prompts)
    tok = np.zeros((Bp, max_len), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        tok[i, :len(p)] = p
    cache = ref_serve.init_cache(cfg, Bp, max_len + n + 1, ring=ring)
    _, cache, _ = ref_tf.forward(jp, cfg, {"tokens": jnp.asarray(tok),
                                           "pos": jnp.zeros(Bp, jnp.int32)},
                                 cache=cache)
    cache = ref_engine._set_lens(cache, jnp.asarray(lens))
    step = jax.jit(lambda c, t, q: ref_serve.decode_step(jp, cfg, t, q,
                                                         c)[1:])
    last, pos, out = tok[np.arange(Bp), lens - 1][:, None], lens - 1, []
    for t in range(n):
        logits, cache = step(ref_engine._set_lens(cache, jnp.asarray(pos)),
                             jnp.asarray(last), jnp.asarray(pos))
        out.append(np.asarray(logits[:, -1]))
        last, pos = tokens[:, t:t + 1], pos + 1
    return np.stack(out, 1)


def _guarded_equal(got, want, scores, guard):
    """Rows of tokens equal up to each row's first step whose top-2
    margin of ``scores`` (B, n, V) is at most ``guard``; returns the
    steps left uncompared."""
    top2 = np.sort(scores, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    skipped = 0
    for i, (g, w) in enumerate(zip(got, want)):
        for t in range(len(g)):
            if margin[i, t] <= guard:
                skipped += len(g) - t
                break
            assert g[t] == w[t], (i, t, g, w, margin[i, t], guard)
    return skipped


def _generate_case(cfg, jp, tp, *, temperature=0.0, seed=0, ring=False,
                   n=NEW_TOKENS):
    kw = dict(max_new_tokens=n, temperature=temperature, ring=ring)
    steps = []
    got = engine.generate(tp, cfg, PROMPTS, key=rng.key(seed, "cpu"),
                          device="cpu", step_logits=steps, **kw)
    want = ref_engine.generate(jp, cfg, PROMPTS, key=jax.random.key(seed),
                               **kw)
    assert [len(g) for g in got] == [n] * len(PROMPTS)
    port_logits = torch.stack(steps, 1).numpy()
    ref_logits = _reference_step_logits(jp, cfg, PROMPTS, np.array(got),
                                        ring=ring)
    _close(port_logits, ref_logits)
    diff = float(np.abs(port_logits - ref_logits).max())
    scores, guard = port_logits, 2 * diff
    if temperature > 0:
        key, noise = rng.key(seed, "cpu"), []
        for _ in range(n):
            key, sub = rng.split(key)
            noise.append(rng.gumbel(sub, port_logits[:, 0].shape).numpy())
        scores = port_logits / temperature + np.stack(noise, 1)
        guard = 2 * diff / temperature
    # the port's own choice at every step, then the reference's engine
    np.testing.assert_array_equal(np.argmax(scores, -1), np.array(got))
    skipped = _guarded_equal(got, want, scores, guard)
    print(f"{cfg.name}: T={temperature} ring={ring}: {skipped} of "
          f"{n * len(PROMPTS)} tokens under the margin guard {guard:.3g}")
    assert skipped < n * len(PROMPTS)


@pytest.mark.parametrize("name", CAUSAL)
def test_generate_greedy(name, models):
    _generate_case(*models(name))


@pytest.mark.parametrize("name", CAUSAL)
def test_generate_sampled(name, models):
    _generate_case(*models(name), temperature=0.8, seed=5)


@pytest.mark.parametrize("name", ["granite-3-2b", "gemma2-27b"])
def test_generate_ring(name, models):
    """``ring=True`` on a ``with_long_context(window=16)`` variant: the
    window-sized ring is the only cache of its attention segment, and the
    decode runs past 16 positions, so the ring wraps."""
    cfg = ref_configs.get_config(name + "-smoke").with_long_context(16)
    cfg, jp, tp = models(name + "-sw16", cfg)
    ring = serve_step.init_cache(cfg, len(PROMPTS), 64, ring=True,
                                 device="cpu")
    assert ring["segments"][0]["k"].shape[2] == 16
    assert "slot_pos" in ring["segments"][0]
    _generate_case(cfg, jp, tp, ring=True, n=12)      # 7 + 12 > 16: wraps
