"""The zoo's training substrate in the port (``train/optimizer.py``,
``train/train_step.py``'s remat and chunked CE, ``train/checkpoint.py``
for a model, the ``lm`` launcher and ``examples/train_lm.py``) against
the JAX reference, on the CPU.

* ``adamw_update``: bit for bit with the reference run eagerly over
  three steps while the clip scale is 1 (no op contracts, and the bias
  corrections take XLA CPU's ``powf``), also with a schedule for lr; with
  clipping active or the reference under ``jit``, params within one ulp
  of the larger of their value before the step and the step (the global
  norm's sum order is not the
  reference's, so the clip scale may differ in its last bits, and
  ``jit`` contracts ``a*b + c``); m and v within 1e-6 relative.
* ``cosine_schedule``: equal at the warm-up, the peak and the end.
* The chunked CE in two real chunks: within 1e-5 of the reference's.
* Checkpoints of a model cross packages both ways with equal arrays.
* The launcher's ramp batches equal the reference's bit for bit.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as ref_configs
from repro.models import transformer as ref_tf
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch import convert, rng
from repro_torch.configs import get_config
from repro_torch.launch.train import lm_batch
from repro_torch.models import transformer
from repro_torch.train import checkpoint, optimizer
from repro_torch.train import train_step as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"a": (64, 32), "b": {"c": (128,), "d": (8, 8, 8)}}


def _tree(r, scale):
    return jax.tree_util.tree_map(
        lambda s: (r.standard_normal(s) * scale).astype(np.float32), SHAPES,
        is_leaf=lambda x: isinstance(x, tuple))


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch(tree) -> dict:
    return {k: torch.as_tensor(v.copy()) for k, v in _flat(tree).items()}


def _within_an_ulp(got: torch.Tensor, want: np.ndarray,
                   before: np.ndarray) -> bool:
    """|got - want| at most one ulp of the larger operand of the step's
    last subtraction ``p - lr·delta``: the param before the step or the
    step itself."""
    big = np.maximum(np.abs(before), np.abs(before - want)).astype(
        np.float32)
    return bool(np.all(np.abs(got.numpy().astype(np.float64) - want)
                       <= np.spacing(big)))


def _run_both(params, grads_seq, jit=False, **kw):
    upd = jax.jit(ref_opt.adamw_update, static_argnames=tuple(kw)) if jit \
        else ref_opt.adamw_update
    p, st = params, ref_opt.adamw_init(params)
    pp = _torch(params)
    pst = optimizer.adamw_init(pp)
    for g in grads_seq:
        p, st, gn = upd(p, g, st, **kw)
        pp, pst, pgn = optimizer.adamw_update(pp, _torch(g), pst, **kw)
    return (p, st, gn), (pp, pst, pgn)


# ------------------------------------------------------------- optimizer
def test_adamw_bit_equal_to_the_eager_reference_at_clip_scale_one():
    r = np.random.default_rng(0)
    params = _tree(r, 1.0)
    grads = [_tree(r, 1e-3) for _ in range(3)]     # global norm ~0.05 < 1
    (p, st, gn), (pp, pst, pgn) = _run_both(params, grads, lr=3e-4)
    assert float(gn) < 1.0
    for got, want in ((pp, _flat(p)), (pst.m, _flat(st.m)),
                      (pst.v, _flat(st.v))):
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert int(pst.step) == int(st.step) == 3
    assert abs(float(pgn) - float(gn)) <= 1e-6 * float(gn)


@pytest.mark.parametrize("gscale,jit", [(1.0, False), (1.0, True),
                                        (1e-3, True)])
def test_adamw_within_an_ulp_with_clipping_or_under_jit(gscale, jit):
    """gscale 1.0: global norm ~52, so the grads are clipped."""
    r = np.random.default_rng(1)
    params = _tree(r, 1.0)
    (p, st, gn), (pp, pst, _) = _run_both(params, [_tree(r, gscale)],
                                          jit=jit, lr=3e-4)
    before = _flat(params)
    for k, want in _flat(p).items():
        assert _within_an_ulp(pp[k], want, before[k]), k
    for got, want in ((pst.m, _flat(st.m)), (pst.v, _flat(st.v))):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                       atol=0)


def test_adamw_takes_a_schedule_and_bf16_params():
    r = np.random.default_rng(2)
    params = _tree(r, 1.0)
    grads = [_tree(r, 1e-3) for _ in range(2)]
    sched = optimizer.cosine_schedule(1e-3, 1, 10)
    p, st = params, ref_opt.adamw_init(params)
    for g in grads:
        p, st, _ = ref_opt.adamw_update(p, g, st,
                                        lr=ref_opt.cosine_schedule(1e-3, 1,
                                                                   10))
    pp = _torch(params)
    pst = optimizer.adamw_init(pp)
    for g in grads:
        pp, pst, _ = optimizer.adamw_update(pp, _torch(g), pst, lr=sched)
    for k, want in _flat(p).items():
        np.testing.assert_array_equal(pp[k].numpy(), want, err_msg=k)
    bf = {k: v.to(torch.bfloat16) for k, v in _torch(params).items()}
    bst = optimizer.adamw_init(bf)
    bf, bst, _ = optimizer.adamw_update(bf, _torch(grads[0]), bst, lr=1e-3)
    assert all(v.dtype == torch.bfloat16 for v in bf.values())
    assert all(v.dtype == torch.float32 for v in bst.m.values())


@pytest.mark.parametrize("step", [0, 1, 5, 10, 100, 150])
def test_cosine_schedule_equals_the_reference(step):
    """Warm-up (0, 1, 5), the peak (10), the end (100) and past it."""
    want = np.asarray(ref_opt.cosine_schedule(1e-3, 10, 100)(
        jnp.int32(step)))
    got = optimizer.cosine_schedule(1e-3, 10, 100)(
        torch.tensor(step, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)


def test_adamw_descends_a_quadratic():
    """The reference's own case (``tests/test_train.py``)."""
    params = {"w": torch.tensor([3.0, -2.0])}
    state = optimizer.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = optimizer.adamw_update(params, grads, state,
                                                  lr=0.05, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.1


def test_adamw_clips_to_the_clip_norm():
    """The reported norm is the one before clipping; the moments see the
    grads scaled to ``clip_norm``."""
    params = {"w": torch.zeros(3)}
    state = optimizer.adamw_init(params)
    _, state, gnorm = optimizer.adamw_update(
        params, {"w": torch.full((3,), 1e6)}, state, lr=0.0)
    assert float(gnorm) > 1e5
    clipped = state.m["w"] / (1 - 0.9)          # m = (1 - b1)·g·scale
    assert float(clipped.norm()) == pytest.approx(1.0, rel=1e-6)


# ------------------------------------------------------- loss and remat
def test_chunked_ce_in_two_chunks_equals_the_reference():
    """Hidden states of 1,024 rows straight into the chunked CE (two
    chunks of 512; no S the attention takes gives two), loss and grads
    against the reference's ``_chunked_ce_from_hidden``."""
    r = np.random.default_rng(3)
    cfg = get_config("gemma2-27b-smoke")                 # softcap, tied
    x = r.standard_normal((2, 1024, cfg.d_model)).astype(np.float32)
    head = r.standard_normal((cfg.d_model, cfg.vocab_size)).astype(
        np.float32) * 0.05
    t = r.integers(0, cfg.vocab_size, (2, 1024)).astype(np.int32)
    mask = np.ones((2, 1024), np.float32)

    def ref(x, head):
        return ref_ts._chunked_ce_from_hidden(x, head, jnp.asarray(t),
                                              jnp.asarray(mask),
                                              cfg.final_logit_softcap)
    want, (gx, gh) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    xt = torch.as_tensor(x).requires_grad_(True)
    ht = torch.as_tensor(head).requires_grad_(True)
    got = ts._chunked_ce_from_hidden(xt, ht, torch.as_tensor(t),
                                     torch.as_tensor(mask),
                                     cfg.final_logit_softcap)
    got_gx, got_gh = torch.autograd.grad(got, [xt, ht])
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    for g, w in ((got_gx, gx), (got_gh, gh)):
        w = np.array(w)
        assert float((g - torch.as_tensor(w)).abs().max()) <= \
            1e-4 * np.abs(w).max()


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _ops(cfg, state, batch, **kw):
    with _Count() as c:
        ts.value_and_grad(state.params, cfg, batch, **kw)
    return c.ops


def test_remat_saves_the_projections_and_recomputes_the_rest():
    """Whole-loss remat runs the forward's softmax and batched products
    again in the backward but no projection (``mm``); per-layer remat
    runs every layer's projections again too."""
    cfg = get_config("qwen3-8b-smoke")
    state = ts.init_train_state(cfg, 0, device="cpu")
    batch = {"tokens": torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))}
    plain = _ops(cfg, state, batch, remat=False)
    remat = _ops(cfg, state, batch, remat=True)
    layer = _ops(cfg, state, batch, layer_remat=True)
    aten = torch.ops.aten
    assert remat[aten.mm.default] == plain[aten.mm.default]
    assert remat[aten._softmax.default] == 2 * plain[aten._softmax.default]
    assert remat[aten.bmm.default] > plain[aten.bmm.default]
    assert layer[aten.mm.default] > plain[aten.mm.default]


def test_forward_refuses_sharding_constraints():
    cfg = get_config("qwen3-8b-smoke")
    model = transformer.init_params(cfg, 0, device="cpu")
    # S = 1 too: attention's sequence constraint applies only above it
    for S in (4, 1):
        tok = {"tokens": torch.zeros((1, S), dtype=torch.int32)}
        for kw in ({"act_sharding": "data"}, {"attn_seq_sharding": "model"}):
            with pytest.raises(ValueError, match="one device"):
                transformer.forward(model, cfg, tok, **kw)


def test_weights_take_gradients_only_in_a_train_state():
    cfg = get_config("qwen3-8b-smoke")
    model = transformer.init_params(cfg, 0, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    state = ts.train_state(model)
    assert all(p.requires_grad for p in state.params.parameters())
    assert set(state.opt.m) == set(dict(model.named_parameters()))


# ------------------------------------------------------------ checkpoint
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_checkpoint_crosses_packages(tmp_path, dtype):
    cfg = ref_configs.get_config("zamba2-2.7b-smoke")
    jp = ref_tf.init_params(cfg, jax.random.key(0))
    ref_ckpt.save(str(tmp_path / "ref.npz"), jp)
    model = ts.init_train_state(cfg, 0, dtype, device="cpu").params
    got = checkpoint.restore(str(tmp_path / "ref.npz"), model)
    assert got.embed.dtype == dtype
    want = convert.params_from_reference(
        jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu",
        dtype=dtype)
    for (k, a), b in zip(got.state_dict().items(),
                         want.state_dict().values()):
        assert torch.equal(a, b), k
    checkpoint.save(str(tmp_path / "port.npz"), model)
    back = ref_ckpt.restore(str(tmp_path / "port.npz"), jp)
    for (k, a), b in zip(
            convert.params_from_reference(jax.tree_util.tree_map(
                np.asarray, back), cfg, device="cpu").state_dict().items(),
            model.state_dict().values()):
        assert torch.equal(a, b.float()), k


def test_train_state_crosses_packages():
    cfg = ref_configs.get_config("deepseek-moe-16b-smoke")
    st = ref_ts.init_train_state(cfg, jax.random.key(0))
    st = st._replace(opt=st.opt._replace(
        step=jnp.int32(7),
        m=jax.tree_util.tree_map(lambda a: a + 0.5, st.opt.m),
        v=jax.tree_util.tree_map(lambda a: a + 0.25, st.opt.v)))
    host = jax.tree_util.tree_map(np.asarray, st)
    port = convert.train_state_from_reference(host, cfg, device="cpu")
    assert int(port.opt.step) == 7
    back = convert.train_state_to_reference(port)
    assert int(back["step"]) == 7
    for name, want in (("params", host.params), ("m", host.opt.m),
                       ("v", host.opt.v)):
        got_l = jax.tree_util.tree_leaves_with_path(back[name])
        want_l = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_l] == [p for p, _ in want_l]
        for (path, g), (_, w) in zip(got_l, want_l):
            np.testing.assert_array_equal(g, w, err_msg=str(path))


# ------------------------------------------------------ launcher, example
@pytest.mark.parametrize("name", ["qwen3-8b", "hubert-xlarge",
                                  "internvl2-1b"])
def test_launcher_batches_are_the_reference_bits(name):
    """``lm_batch`` under the reference launcher's keys: the ramp, the
    labels and the tokens equal ``jax.random``'s; frames and patches
    have the reference's shapes."""
    cfg = get_config(name).smoke()
    key, pkey = jax.random.key(1), rng.key(1, "cpu")
    B, S = 4, 128
    for _ in range(2):
        key, k1 = jax.random.split(key)
        pkey, pk1 = rng.split(pkey)
        got = lm_batch(cfg, pk1, B, S)
        if cfg.modality == "audio_frames":
            want = jax.random.randint(k1, (B, S), 0, cfg.vocab_size)
            np.testing.assert_array_equal(got["labels"].numpy(), want)
            assert got["frames"].shape == (B, S, cfg.frontend_dim)
        elif cfg.modality == "image_patches":
            want = jax.random.randint(k1, (B, S), 0, cfg.vocab_size)
            np.testing.assert_array_equal(got["tokens"].numpy(), want)
            assert got["patches"].shape == (B, cfg.frontend_tokens,
                                            cfg.frontend_dim)
        else:
            start = jax.random.randint(k1, (B, 1), 0, cfg.vocab_size)
            want = (start + jnp.arange(S)[None, :] * 7) % cfg.vocab_size
            np.testing.assert_array_equal(got["tokens"].numpy(), want)


def _run(module, *args, timeout=300):
    # one thread: the test runners share the host's cores, and a torch
    # process spinning on all of them beside others runs many times slower
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=REPO)


def test_lm_launcher_runs_on_the_cpu():
    out = _run("repro_torch.launch.train", "lm", "--smoke", "--steps", "2",
               "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("[lm] qwen3-8b-smoke:")
    loss = float(lines[-1].split("loss")[1])
    assert lines[-1].startswith("[lm] step    2") and np.isfinite(loss)


def test_train_lm_example_reduces_the_loss(tmp_path):
    ckpt = str(tmp_path / "lm.npz")
    out = _run("repro_torch.examples.train_lm", "--steps", "30",
               "--device", "cpu", "--ckpt", ckpt)
    assert out.returncode == 0, out.stderr[-2000:]
    first, last = (float(v) for v in out.stdout.split("loss ")[-1]
                   .split(" in ")[0].split(" -> "))
    assert last < first
    # the saved params are the reference's format
    data = np.load(ckpt)
    assert "embed" in data.files and "segments/0/mixer/wq" in data.files
    assert json.dumps(sorted(data.files))      # readable
