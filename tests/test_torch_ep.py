"""Expert parallelism in the port (``models/moe.py:moe_forward_ep`` and
``moe_forward_ep_lockstep``, ``launch/ep.py``, ``launch/ep_check.py``)
against the JAX reference and against itself, on the CPU.

The reference's ``moe_forward_ep`` runs on 4 fake XLA CPU devices in a
subprocess (``tests/torch_ep_reference.py``), which writes its weights,
tokens, y and aux; the port takes the same weights and tokens.  Checks:

* the gloo form (4 spawned processes, ``all_to_all_single``) and the
  lock-step form equal bit for bit, output and aux;
* both within 1e-5 of the largest |y| of the reference's EP output, aux
  within 1e-6;
* both against the port's ``moe_forward`` at capacity factor 8.0 (no
  choice dropped), y and the gradients within 1e-5 of their largest
  |value|; the gloo group's gradients (summed over the ranks) within
  1e-5 of the lock-step form's;
* a train step with the lock-step ``ep_ctx`` within tolerance of the
  same step through ``moe_forward`` at the same capacity;
* where S is not a multiple of M, ``moe_forward`` itself.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import ep_check
from repro_torch.launch.ep import make_ep_ctx
from repro_torch.models import moe as moe_mod
from repro_torch.train import train_step as ts

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
M = 4
FACTOR = 8.0


def _rel(got, want) -> float:
    want = torch.as_tensor(want)
    return float((torch.as_tensor(got) - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's EP run on 4 fake devices, and its inputs in the
    port: (cfg, MoE module, x, npz)."""
    out = str(tmp_path_factory.mktemp("ep") / "ep.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable,
                          os.path.join(HERE, "torch_ep_reference.py"), out,
                          str(M)], capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    data = dict(np.load(out))
    cfg = get_config("deepseek-moe-16b").smoke()
    tree: dict = {}
    for k, v in data.items():
        if k.startswith("p/"):
            node = tree
            *path, leaf = k[2:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    p = convert.load_module(moe_mod.MoE(torch.Generator(), cfg,
                                        torch.float32, "cpu"), tree)
    return cfg, p, torch.as_tensor(data["x"]), data


@pytest.fixture(scope="module")
def gloo(reference):
    cfg, p, x, _ = reference
    return ep_check.gloo_forward(cfg.name, p.state_dict(), x, M)


def test_gloo_and_lockstep_forms_are_bit_equal(gloo):
    assert torch.equal(gloo["y"], gloo["y_lockstep"])
    assert torch.equal(gloo["aux"], gloo["aux_lockstep"])
    assert gloo["aux"].shape == ()


def test_both_forms_match_the_reference_ep(reference, gloo):
    cfg, p, x, data = reference
    with torch.no_grad():
        y_b, aux_b = make_ep_ctx(M, cfg, capacity_factor=FACTOR)(p, x)
    for y, aux in ((gloo["y"], gloo["aux"]), (y_b, aux_b)):
        assert _rel(y, data["y_ep"]) <= 1e-5
        assert abs(float(aux) - float(data["aux_ep"])) <= 1e-6


def test_both_forms_match_moe_forward(reference, gloo):
    """y and the gradients of (y·probe).sum() by x and each weight: the
    lock-step form against ``moe_forward`` (aux left out: the EP path
    averages the chunks' own load-balance terms, not the whole batch's).
    The gloo group's gradients of (y·probe).sum() + aux, summed over the
    ranks, against the lock-step form's."""
    cfg, p, x, data = reference
    p.requires_grad_(True)
    names = dict(p.named_parameters())

    def grads(f):
        xg = x.clone().requires_grad_(True)
        y, _ = f(p, xg)
        return y.detach(), dict(zip(["x", *names], torch.autograd.grad(
            (y * ep_check.probe(y)).sum(), [xg, *names.values()])))

    y1, g1 = grads(lambda p, x: moe_mod.moe_forward(
        p, cfg, x, capacity_factor=FACTOR))
    y2, g2 = grads(make_ep_ctx(M, cfg, capacity_factor=FACTOR))
    assert _rel(y1, data["y_single"]) <= 1e-5
    assert _rel(y2, y1) <= 1e-5 and _rel(gloo["y"], y1) <= 1e-5
    for k, g in g1.items():
        assert _rel(g2[k], g) <= 1e-5, k
    for k, g in gloo["grads_lockstep"].items():
        assert _rel(gloo["grads"][k], g) <= 1e-5, k


def test_train_step_with_ep_matches_the_step_without(reference):
    """deepseek-moe at smoke size, S = 16 over M = 4 ranks, the aux term
    left out of the loss (the EP path averages the chunks' own terms): the
    gradients and the step through the lock-step ``ep_ctx`` against the
    same through ``moe_forward``, both at capacity factor 8.0.  Gradients
    within 1e-5 of each leaf's largest |value|, the metrics within 1e-5,
    m within 1e-4 of its largest |value|; a weight moves by about
    lr·sign(g), so one whose tiny gradient differs in sign may differ by
    2·lr, no more."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b-smoke"),
                              router_aux_coef=0.0)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))}
    lr = 3e-4
    out = []
    for ep in (make_ep_ctx(M, cfg, capacity_factor=FACTOR),
               lambda p, x: moe_mod.moe_forward(p, cfg, x,
                                                capacity_factor=FACTOR)):
        state = ts.init_train_state(cfg, 0, device="cpu")
        _, grads = ts.value_and_grad(state.params, cfg, batch, remat=False,
                                     ep_ctx=ep)
        state, metrics = ts.make_train_step(cfg, lr=lr, remat=False,
                                            ep_ctx=ep)(state, batch)
        out.append((grads, state, metrics))
    (g1, s1, m1), (g2, s2, m2) = out
    for k in g1:
        assert _rel(g1[k], g2[k]) <= 1e-5, k
    for k in ("loss", "ce", "grad_norm"):
        assert abs(float(m1[k]) - float(m2[k])) <= 1e-5 * abs(float(m2[k]))
    for k in s1.opt.m:
        assert _rel(s1.opt.m[k], s2.opt.m[k]) <= 1e-4, k
    for (k, a), b in zip(s1.params.named_parameters(),
                         s2.params.parameters()):
        assert float((a - b).detach().abs().max()) <= 2 * lr, k


def test_fallback_where_s_is_not_a_multiple_of_m(reference):
    cfg, p, x, _ = reference
    x6 = x[:, :6]
    with torch.no_grad():
        got = make_ep_ctx(M, cfg, capacity_factor=FACTOR)(p, x6)
        want = moe_mod.moe_forward(p, cfg, x6, capacity_factor=FACTOR)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_no_context_where_ep_is_not_viable():
    moe = get_config("deepseek-moe-16b").smoke()        # 4 experts
    assert make_ep_ctx(1, moe) is None
    assert make_ep_ctx(3, moe) is None
    assert make_ep_ctx(2, get_config("qwen3-8b").smoke()) is None
    assert make_ep_ctx(2, moe) is not None


def test_ep_check_twin_agrees_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.ep_check",
                          "4", "--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["agree"] and rep["forms_equal"] and rep["form"] == "gloo"
    assert rep["n_devices"] == 4
