"""Shared cases of ``tests/test_torch_train_zoo*.py``: the zoo's loss,
gradients and one training step in the port against the JAX reference,
for a list of archs at ``.smoke()`` size, on the CPU.

The reference's training state (``init_train_state``, key 0) is carried
into the port with ``convert.train_state_from_reference``.  Tolerances:

* the loss, ``ce``, ``aux`` and ``grad_norm``: within ``LOSS_TOL`` =
  1e-5 relative;
* every gradient leaf: within ``GRAD_TOL`` = 1e-4 of that leaf's largest
  |value| (the packages' f32 matrix products reduce in different
  orders);
* a step of the port's ``make_train_step`` with whole-loss remat,
  without it and with ``layer_remat``, each against the reference's step
  without remat under ``jit`` (its remat recomputes the same function):
  m within GRAD_TOL of
  its leaf's largest |value| and v within 2·GRAD_TOL (it squares the
  gradient); the new params at every entry whose |gradient| exceeds
  twice that leaf's gradient error e measured in the same case (AdamW's
  first step moves a weight by about lr·sign(g), so a gradient within
  the error of 0 may flip and move its weight by 2·lr).  There the step
  is lr·(r + wd·p) with r = |g|s / (|g|s + eps) (s the clip scale), and
  the params must agree within lr times the spread of r over |g| ± (e +
  LOSS_TOL·|g|), plus LOSS_TOL of the step and one ulp of the largest of
  |p| before and after and the step.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.train import train_step as ref_ts
from repro_torch import convert
from repro_torch.train import train_step as ts

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
LR = 3e-4
B, S = 2, 16
#: S - 1 = 512: the chunked CE's chunk is a whole 512 rows.  The SSD
#: takes S in multiples of 256, so the SSM archs run one chunk of 255.
S_CHUNKED, S_CHUNKED_SSM = 513, 256
VARIANTS = {"plain": dict(remat=False), "remat": dict(remat=True),
            "layer_remat": dict(layer_remat=True)}


def batch(cfg, S=S, seed=1) -> dict:
    r = np.random.default_rng(seed)
    if cfg.modality == "audio_frames":
        return {"frames": r.standard_normal(
                    (B, S, cfg.frontend_dim)).astype(np.float32),
                "labels": r.integers(0, cfg.vocab_size, (B, S)).astype(
                    np.int32)}
    out = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.modality == "image_patches":
        out["patches"] = r.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def reference(name: str) -> dict:
    """The reference's state, batch, loss, metrics and gradients for
    ``name``; its steps are computed on first use (:func:`ref_step`)."""
    cfg = ref_configs.get_config(name + "-smoke")
    st = jax.jit(functools.partial(ref_ts.init_train_state, cfg))(
        jax.random.key(0))
    b = batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_ts.loss_fn(p, cfg, jb), has_aux=True))(st.params)
    return {"cfg": cfg, "state": _np(st), "batch": b,
            "loss": float(loss), "metrics": _np(metrics),
            "grads": convert.named_from_reference(_np(grads))}


@functools.lru_cache(maxsize=None)
def ref_step(name: str) -> dict:
    """The reference's jitted ``make_train_step(remat=False)`` step.  Its
    remat policies recompute the same function, so each of the port's
    three variants is held to this one step."""
    ref = reference(name)
    cfg = ref["cfg"]
    st = jax.tree_util.tree_map(jnp.asarray, ref["state"])
    jb = {k: jnp.asarray(v) for k, v in ref["batch"].items()}
    new, metrics = jax.jit(ref_ts.make_train_step(cfg, lr=LR, remat=False))(
        st, jb)
    return {"state": _np(new), "metrics": _np(metrics)}


def port_state(name: str):
    ref = reference(name)
    return convert.train_state_from_reference(ref["state"], ref["cfg"],
                                              device="cpu")


def port_batch(b: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _close(got, want, tol):
    got = float(got)
    assert abs(got - float(want)) <= tol * max(abs(float(want)), 1e-30), \
        (got, float(want))


@functools.lru_cache(maxsize=None)
def grad_errors(name: str) -> dict:
    """name -> (max |port - reference| of the leaf, its largest |value|)
    for the gradient of the loss in :func:`reference`."""
    ref = reference(name)
    state = port_state(name)
    _, grads = ts.value_and_grad(state.params, ref["cfg"],
                                 port_batch(ref["batch"]), remat=False)
    return {k: (float(np.abs(g.numpy() - ref["grads"][k]).max()),
                float(np.abs(ref["grads"][k]).max()))
            for k, g in grads.items()}


def _ratio(g, scale, eps=1e-8):
    """AdamW's first-step mh / (sqrt(vh) + eps) for |gradient| g."""
    return g * scale / (g * scale + eps)


def make_tests(names: list):
    """The test functions for ``names``, to assign at a test module's top
    level."""
    text = [n for n in names
            if ref_configs.get_config(n).modality == "text"]

    @pytest.mark.parametrize("name", names)
    def test_loss_fn_matches_reference(name):
        ref = reference(name)
        state = port_state(name)
        with torch.no_grad():
            loss, metrics = ts.loss_fn(state.params, ref["cfg"],
                                       port_batch(ref["batch"]))
        _close(loss, ref["loss"], LOSS_TOL)
        _close(metrics["ce"], ref["metrics"]["ce"], LOSS_TOL)
        _close(metrics["aux"], ref["metrics"]["aux"], LOSS_TOL)

    @pytest.mark.parametrize("name", names)
    def test_grads_match_reference(name):
        errors = grad_errors(name)
        assert set(errors) == set(reference(name)["grads"])
        for k, (err, scale) in errors.items():
            assert err <= GRAD_TOL * scale, (k, err, scale)

    @pytest.mark.parametrize("name", text)
    def test_chunked_ce_matches_reference(name):
        """S - 1 = 512, so the chunk is a whole 512 rows (255 for the
        SSM archs)."""
        ref = reference(name)
        cfg = ref["cfg"]
        b = batch(cfg, S_CHUNKED_SSM if cfg.ssm_state else S_CHUNKED,
                  seed=2)
        params = jax.tree_util.tree_map(jnp.asarray, ref["state"].params)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: ref_ts.loss_fn(p, cfg, {"tokens": jnp.asarray(
                b["tokens"])}, chunked_ce=True), has_aux=True))(params)
        want = convert.named_from_reference(_np(grads))
        state = port_state(name)
        (got, _), got_g = ts.value_and_grad(state.params, cfg,
                                            port_batch(b), remat=False,
                                            chunked_ce=True)
        _close(got, loss, LOSS_TOL)
        for k, g in got_g.items():
            scale = float(np.abs(want[k]).max())
            assert float(np.abs(g.numpy() - want[k]).max()) <= \
                GRAD_TOL * scale, k

    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    @pytest.mark.parametrize("name", names)
    def test_train_step_matches_reference(name, variant):
        ref = reference(name)
        want = ref_step(name)
        state = port_state(name)
        before = {k: p.detach().clone()
                  for k, p in state.params.named_parameters()}
        new, metrics = ts.make_train_step(ref["cfg"], lr=LR,
                                          **VARIANTS[variant])(
            state, port_batch(ref["batch"]))
        for k in ("loss", "ce", "aux", "grad_norm"):
            _close(metrics[k], want["metrics"][k], LOSS_TOL)
        assert int(new.opt.step) == int(want["state"].opt.step) == 1
        errors = grad_errors(name)
        scale = min(1.0, 1.0 / max(float(want["metrics"]["grad_norm"]),
                                   1e-9))
        w_params = convert.named_from_reference(want["state"].params)
        w_m = convert.named_from_reference(want["state"].opt.m)
        w_v = convert.named_from_reference(want["state"].opt.v)
        for k, p in new.params.named_parameters():
            for got, w, tol in ((new.opt.m[k], w_m[k], GRAD_TOL),
                                (new.opt.v[k], w_v[k], 2 * GRAD_TOL)):
                assert float(np.abs(got.numpy() - w).max()) <= \
                    tol * max(float(np.abs(w).max()), 1e-30), k
            g = np.abs(ref["grads"][k]).astype(np.float64)
            held = g > 2 * errors[k][0]
            e = errors[k][0] + LOSS_TOL * g
            spread = _ratio(g + e, scale) - _ratio(np.maximum(g - e, 0),
                                                   scale)
            p0 = before[k].numpy()
            w = w_params[k]
            step = np.abs(p0 - w)
            big = np.maximum(np.maximum(np.abs(p0), np.abs(w)),
                             step).astype(np.float32)
            diff = np.abs(p.detach().numpy().astype(np.float64) - w)
            ok = diff <= LR * spread + LOSS_TOL * step + np.spacing(big)
            assert ok[held].all(), (k, int((~ok & held).sum()),
                                    int(held.sum()))

    return (test_loss_fn_matches_reference, test_grads_match_reference,
            test_chunked_ce_matches_reference,
            test_train_step_matches_reference)
