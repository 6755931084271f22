"""The model zoo's training path on a device, checked against itself and
against the CPU (phase (j) of ``chip_smoke.py``).  The training
counterpart of ``launch/zoo_serve_check.py``.

Four parts, each printing one JSON line and raising
:class:`ZooTrainCheckError` on the first check that fails:

* ``smoke``: all ten archs at ``.smoke()`` size, weights drawn on the
  device from a seeded ``torch.Generator`` and copied to the CPU, B = 2,
  S = 32.  The loss and its gradients on the device against the CPU's
  (the loss within ``LOSS_TOL`` relative, each gradient within
  ``GRAD_TOL`` of its largest |value|), then one AdamW step on each whose
  ``grad_norm`` agrees within ``LOSS_TOL``.  Then ``launch/ep_check.py``
  on the device (M = 4).
* ``granite``: ``granite-3-2b`` at its published widths and full depth
  (40 layers, 2.53 B parameters; f32 params, grads, m and v, 16 B a
  parameter), B = 4, S = 1024, ``layer_remat`` and the chunked CE, every
  step on the reference launcher's first ramp batch, so the steps'
  losses compare.  The CE is one chunk of 1,023 rows: the reference's
  CE splits only where S - 1 is a multiple of 512, and its attention
  (and the port's) takes S above 1,024 only in multiples of 1,024, so no
  S that both take gives two chunks.  The two-chunk path is held on its
  own, at granite's vocabulary, on random hidden states.  The
  first step's loss must equal ``loss_fn`` under ``no_grad`` on the same
  batch bit for bit (remat leaves the forward's numbers alone), the grad
  norm stay finite and the loss fall over the steps.  The last step runs
  under ``torch.profiler``.  One more step runs under
  ``roofline/hlo_cost.analyze_step``; its product flops must equal the
  dry-run's count of the same step on a one-device mesh of a fake group
  (``launch/dryrun.one_device_cost``, meta tensors).  Then the card
  against the CPU at full width,
  depth 2, B = 2, S = 128: loss and gradients as in ``smoke``, the card
  with whole-loss remat, without it and with ``layer_remat``, each
  against one CPU step without remat (remat recomputes the same
  function).
* ``moe``: ``deepseek-moe-16b`` at full width, depth cut to 4 (the dense
  first layer and 3 MoE layers), 3 steps at B = 4, S = 256, the choices
  dropped at the default capacity counted.  Then expert parallelism at
  full width: ``moe_forward_ep`` in lock step with M = 4 (16 experts a
  rank) against ``moe_forward`` on the first MoE layer, both at capacity
  factor 8.0: y and the gradients of a fixed linear function of y by x,
  the router and the experts within ``EP_TOL`` of their largest |value|;
  aux within ``AUX_TOL`` of the mean of the four token chunks' own
  load-balance terms, which is what the EP path averages (the whole
  batch's term differs from it).
* ``mamba2``: ``mamba2-1.3b`` at full width and depth (48 layers), 3
  steps at B = 4, S = 1024 (the SSD takes S in multiples of 256; its CE
  is one chunk), ``layer_remat``; checked as ``granite``, with the card
  against the CPU at depth 2.

TF32 stays off (PyTorch's default for f32 matrix products), so the card
multiplies in full f32 as the CPU does.  ``--scale small`` runs the same
code on the smoke configs, for a rehearsal on the CPU.

    python -m repro_torch.launch.zoo_train_check --device cpu --scale small

Prints one JSON line a part and last ``{"ok": ...}``; exits non-zero
unless every check passes.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys
import time

import numpy as np
import torch

from repro_torch import rng
from repro_torch._device import resolve
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun, ep_check
from repro_torch.launch.ep import make_ep_ctx
from repro_torch.launch.train import lm_batch
from repro_torch.launch.zoo_serve_check import _Drops, _batch
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer
from repro_torch.models.layers import softcap
from repro_torch.roofline.hlo_cost import analyze_step
from repro_torch.train.optimizer import adamw_update
from repro_torch.train.train_step import (_chunked_ce_from_hidden,
                                          _cross_entropy, loss_fn,
                                          make_train_step, train_state,
                                          value_and_grad)

__all__ = ["ZooTrainCheckError", "smoke_arch", "granite_full", "moe_full",
           "mamba2_full", "run"]

#: Loss and grad norm of two devices: relative difference.
LOSS_TOL = 1e-5
#: A gradient of two devices: max |diff| over its largest |value|.
GRAD_TOL = 1e-4
#: Expert parallelism against the single-program MoE: y and gradients.
EP_TOL = 1e-5
AUX_TOL = 1e-6
SEED = 0
PARTS = ("smoke", "granite", "moe", "mamba2")
VARIANTS = {"plain": dict(remat=False), "remat": dict(remat=True),
            "layer_remat": dict(layer_remat=True)}


class ZooTrainCheckError(AssertionError):
    """A zoo training check failed."""


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ZooTrainCheckError(msg)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    diff = (got.float().to(want.device) - want).abs().max()
    return float(diff / want.abs().max().clamp_min(1e-30))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _generator(dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(SEED)


def _cpu_state(state, cfg):
    """The same weights on the CPU, in a fresh training state."""
    cpu = transformer.empty_params(cfg, device="cpu")
    cpu.load_state_dict(state.params.state_dict())
    return train_state(cpu)


def _to(batch: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in batch.items()}


def _step_values(state, cfg, batch, **kw) -> tuple:
    """(loss, grads, grad norm) of one AdamW step on ``state``, which the
    step updates."""
    (loss, _), grads = value_and_grad(state.params, cfg, batch, **kw)
    norm = adamw_update(dict(state.params.named_parameters()), grads,
                        state.opt, lr=3e-4)[2]
    return float(loss), grads, float(norm)


def cpu_values(state, cfg, batch, **kw) -> tuple:
    """:func:`_step_values` of the same weights and batch on the CPU."""
    return _step_values(_cpu_state(state, cfg), cfg, _to(batch, "cpu"),
                        **kw)


def card_vs_cpu(state, cfg, batch, want=None, **kw) -> dict:
    """Loss and gradients of ``state`` on its device against the same
    weights on the CPU, then one AdamW step on each: the loss and the
    grad norm within LOSS_TOL relative, each gradient within GRAD_TOL of
    its largest |value|.  ``kw``: the step's remat and CE options;
    ``want``: the CPU's :func:`cpu_values`, where several variants of
    the step share one (remat recomputes the same function)."""
    want = want or cpu_values(state, cfg, batch, **kw)
    got = _step_values(state, cfg, batch, **kw)
    rep = {"loss_rel": abs(got[0] - want[0]) / abs(want[0]),
           "grad_rel": max(_rel(got[1][k], g) for k, g in want[1].items()),
           "grad_norm_rel": abs(got[2] - want[2]) / want[2]}
    _check(rep["loss_rel"] <= LOSS_TOL,
           f"{cfg.name} {kw}: loss differs from the CPU's by "
           f"{rep['loss_rel']:.3g}")
    _check(rep["grad_rel"] <= GRAD_TOL,
           f"{cfg.name} {kw}: a gradient differs from the CPU's by "
           f"{rep['grad_rel']:.3g} of its largest |value|")
    _check(rep["grad_norm_rel"] <= LOSS_TOL,
           f"{cfg.name} {kw}: grad norm {got[2]} against the CPU's "
           f"{want[2]}")
    return rep


def _profile_step(step, state, batch, dev) -> dict:
    """One training step under ``torch.profiler``: its wall ms, its
    kernels and the device's busy share, summing the device's own events
    only (a CPU op's device time is its kernels' time again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - wall) * 1e3
    by_name: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {"wall_ms": wall, "device_ms": device_ms, "kernels": n_kernels,
            "device_busy_share": device_ms / wall,
            "top_kernels_ms": {k[:60]: v for k, v in top},
            "loss": float(metrics["loss"])}


def _train(cfg, dev, batches, *, gpu: str, profile: bool = False,
           n_params: int | None = None, **kw) -> tuple:
    """Steps on ``batches`` from fresh weights: the first step's loss
    against ``loss_fn`` under ``no_grad``, each step timed, the loss
    falling and the grad norm finite, the last step profiled when
    ``profile`` and on CUDA.  Returns (report, state)."""
    profile = profile and dev.type == "cuda"
    _free(dev)
    t0 = time.perf_counter()
    state = train_state(transformer.init_params(cfg, _generator(dev),
                                                device=dev))
    _sync(dev)
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in state.params.parameters())
    lkw = {k: v for k, v in kw.items() if k != "remat"}
    with torch.no_grad():
        want = loss_fn(state.params, cfg, batches[0], **lkw)[0]
    step = make_train_step(cfg, lr=3e-4, **kw)
    losses, norms, ms = [], [], []
    timed = batches[:-1] if profile else batches
    for batch in timed:
        _sync(dev)
        t = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    B, S = batches[0]["tokens"].shape
    rep = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "params": n, "state_bytes": 16 * n,
           "B": B, "S": S, "options": kw, "init_s": init_s, "gpu": gpu,
           "dtype": "float32", "tf32": torch.backends.cuda.matmul.allow_tf32,
           "first_loss_equals_no_grad": losses[0] == float(want),
           "losses": losses, "grad_norms": norms, "step_ms": ms}
    _check(rep["first_loss_equals_no_grad"],
           f"{cfg.name}: the first step's loss {losses[0]!r} is not "
           f"loss_fn's {float(want)!r} under no_grad")
    _check(all(math.isfinite(g) for g in norms), "a grad norm is not finite")
    if profile:
        rep["profile"] = _profile_step(step, state, batches[-1], dev)
        losses.append(rep["profile"]["loss"])
    _check(losses[-1] < losses[0],
           f"{cfg.name}: the loss did not fall: {losses}")
    steady = float(np.median(ms[1:] if len(ms) > 1 else ms))
    tokens = B * S
    n_model = n_params or n
    rep.update(steady_step_ms=steady, tokens_a_step=tokens,
               tokens_per_s=tokens / steady * 1e3,
               model_flops_a_step=6 * n_model * tokens,
               model_tflops_per_s_computed=6 * n_model * tokens
               / steady / 1e9)
    if dev.type == "cuda":
        rep["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return rep, state


def _ramp_batches(cfg, n: int, B: int, S: int, dev) -> list:
    """The reference launcher's first text batch (key 1, split once), n
    times: the steps see one batch, so their losses compare."""
    return [lm_batch(cfg, rng.split(rng.key(1, dev))[1], B, S)] * n


def _depth2(cfg, dev, B: int, S: int, **kw) -> dict:
    """The card against the CPU at depth 2: each remat variant's step on
    the card against one CPU step without remat."""
    cut = dataclasses.replace(cfg, num_layers=2)
    _free(dev)
    batch = _ramp_batches(cut, 1, B, S, dev)[0]

    def fresh():
        return train_state(transformer.init_params(cut, _generator(dev),
                                                   device=dev))
    state = fresh()
    out = {"B": B, "S": S,
           "params": sum(p.numel() for p in state.params.parameters())}
    want = cpu_values(state, cut, batch, remat=False, **kw)
    for name, variant in VARIANTS.items():
        out[name] = card_vs_cpu(fresh(), cut, batch, want, **variant, **kw)
    return out


# ------------------------------------------------------------------ parts
def smoke_arch(name: str, dev) -> dict:
    """One arch at smoke size: loss, gradients and a step on ``dev``
    against the CPU."""
    cfg = get_config(name + "-smoke")
    batch = _batch(cfg, 2, 32, np.random.default_rng(SEED), dev)
    if cfg.modality == "audio_frames":
        batch["labels"] = torch.as_tensor(np.random.default_rng(
            SEED + 1).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32),
            device=dev)
    state = train_state(transformer.init_params(cfg, _generator(dev),
                                                device=dev))
    return card_vs_cpu(state, cfg, batch, remat=False)


def smoke_archs(dev, gpu: str = "", small: bool = False) -> dict:
    rep = {name: smoke_arch(name, dev) for name in sorted(ARCHS)}
    if dev.type == "cuda":
        rep["ep_check"] = ep_check.run(4, dev)
        _check(rep["ep_check"]["agree"], f"ep_check: {rep['ep_check']}")
    return rep


def chunked_ce_check(model, cfg, dev, B: int, S: int) -> dict:
    """The chunked CE in two real chunks of 512 rows at the model's full
    vocabulary, on random hidden states (B, S, d) straight into the CE
    (attention takes no S with S - 1 a multiple of 512 and above 512):
    loss and gradients by the hidden states and the head against the
    whole-sequence CE on the same device."""
    r = np.random.default_rng(SEED + 4)
    h = torch.as_tensor(r.standard_normal((B, S, cfg.d_model)).astype(
        np.float32), device=dev).requires_grad_(True)
    t = torch.as_tensor(r.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32), device=dev)
    mask = torch.ones((B, S), dtype=torch.float32, device=dev)
    head = transformer.head_weight(model)
    out = []
    for f in (lambda: _chunked_ce_from_hidden(h, head, t, mask,
                                              cfg.final_logit_softcap),
              lambda: _cross_entropy(softcap(h @ head,
                                             cfg.final_logit_softcap),
                                     t, mask)):
        loss = f()
        out.append((loss.detach(), torch.autograd.grad(loss, [h, head])))
    rep = {"B": B, "S": S, "chunks": S // 512,
           "loss_rel": abs(float(out[0][0]) - float(out[1][0]))
           / abs(float(out[1][0])),
           "grad_rel": max(_rel(a, b) for a, b in zip(out[0][1],
                                                       out[1][1]))}
    _check(rep["loss_rel"] <= LOSS_TOL, f"chunked CE loss differs by "
           f"{rep['loss_rel']:.3g}")
    _check(rep["grad_rel"] <= GRAD_TOL, f"chunked CE gradient differs by "
           f"{rep['grad_rel']:.3g}")
    return rep


def counted_step(state, cfg, batch, dev, **kw) -> dict:
    """One more step under ``analyze_step``: its counts, against the
    dry-run's of the same step on a one-device mesh, whose flops must be
    equal."""
    B, S = batch["tokens"].shape
    step = make_train_step(cfg, lr=3e-4, **kw)
    _sync(dev)
    t = time.perf_counter()
    real = analyze_step(step, state, batch)
    _sync(dev)
    ms = (time.perf_counter() - t) * 1e3
    dry = dryrun.one_device_cost(cfg, "train", B, S, device_type=dev.type,
                                 **kw)
    rep = {"flops": real.flops, "bytes": real.bytes,
           "dry_run_flops": dry.flops, "dry_run_bytes": dry.bytes,
           "counted_step_ms": ms}
    _check(real.flops == dry.flops,
           f"{cfg.name}: the step counts {real.flops} flops, the dry-run "
           f"of it on one device {dry.flops}")
    return rep


def granite_full(dev, gpu: str = "", small: bool = False) -> dict:
    name = "granite-3-2b"
    cfg = get_config(name + "-smoke") if small else get_config(name)
    B, S, steps = (2, 64, 3) if small else (4, 1024, 5)
    kw = dict(layer_remat=True, chunked_ce=True)
    batches = _ramp_batches(cfg, steps, B, S, dev)
    rep, state = _train(cfg, dev, batches, gpu=gpu, profile=True, **kw)
    rep["counted_step"] = counted_step(state, cfg, batches[0], dev, **kw)
    rep["two_chunk_ce"] = chunked_ce_check(state.params, cfg, dev, B, 1024)
    del state
    rep["depth2_card_vs_cpu"] = _depth2(cfg, dev, 2, 32 if small else 128,
                                        chunked_ce=True)
    return rep


def _ep_layer(p, cfg, x, ep) -> tuple:
    """y, aux and the gradients of (y·probe).sum() by x and by the
    router and the experts of MoE layer ``p``."""
    x = x.detach().requires_grad_(True)
    y, aux = ep(p, x)
    names = ("router", "w_gate", "w_up", "w_down")
    grads = torch.autograd.grad((y * ep_check.probe(y)).sum(),
                                [x] + [getattr(p, k) for k in names])
    return y.detach(), aux.detach(), dict(zip(("x",) + names, grads))


def ep_full(p, cfg, dev, B: int, S: int, M: int = 4) -> dict:
    """``moe_forward_ep`` in lock step against ``moe_forward`` on MoE
    layer ``p``, both at capacity factor 8.0."""
    x = torch.as_tensor(np.random.default_rng(SEED + 3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32), device=dev)
    factor = ep_check.CAPACITY_FACTOR
    y1, aux1, g1 = _ep_layer(p, cfg, x, lambda p, x: moe_mod.moe_forward(
        p, cfg, x, capacity_factor=factor))
    y2, aux2, g2 = _ep_layer(p, cfg, x, make_ep_ctx(
        M, cfg, capacity_factor=factor))
    with torch.no_grad():
        chunks = x.reshape(B, M, S // M, -1).transpose(0, 1)
        want_aux = sum(moe_mod.route(p, cfg, c.reshape(-1, cfg.d_model))[2]
                       for c in chunks) / M
        cap = moe_mod.capacity(B * S, cfg, factor)
        keep = moe_mod.dispatch_indices(moe_mod.route(
            p, cfg, x.reshape(-1, cfg.d_model))[1], cfg.num_experts, cap)[2]
    rep = {"M": M, "experts_a_rank": cfg.num_experts // M, "B": B, "S": S,
           "capacity_factor": factor, "dropped_single": int((~keep).sum()),
           "y_rel": _rel(y2, y1),
           "grad_rel": {k: _rel(g2[k], g) for k, g in g1.items()},
           "aux_ep": float(aux2), "aux_chunks_mean": float(want_aux),
           "aux_single": float(aux1),
           "aux_abs_diff": abs(float(aux2) - float(want_aux))}
    _check(rep["y_rel"] <= EP_TOL, f"EP y differs by {rep['y_rel']:.3g}")
    for k, v in rep["grad_rel"].items():
        _check(v <= EP_TOL, f"EP gradient by {k} differs by {v:.3g}")
    _check(rep["aux_abs_diff"] <= AUX_TOL,
           f"EP aux {float(aux2)!r} against {float(want_aux)!r}")
    return rep


def moe_full(dev, gpu: str = "", small: bool = False) -> dict:
    name = "deepseek-moe-16b"
    full = get_config(name + "-smoke") if small else get_config(name)
    cfg = dataclasses.replace(full, num_layers=2 if small else 4)
    B, S = (2, 32) if small else (4, 256)
    batches = _ramp_batches(cfg, 3, B, S, dev)
    rep, state = _train(cfg, dev, batches, gpu=gpu, remat=False,
                        n_params=cfg.active_param_count())
    rep.update(reduced={"num_layers": [full.num_layers, cfg.num_layers]},
               experts=cfg.num_experts, top_k=cfg.experts_per_token,
               shared_experts=cfg.num_shared_experts,
               active_params=cfg.active_param_count(),
               model_flops_counts="active parameters")
    drops = _Drops(state.params)
    try:
        with torch.no_grad():
            transformer.forward(state.params, cfg, batches[-1])
    finally:
        drops.remove()
    dropped, choices = drops.counts["prefill"]
    rep.update(train_batch_dropped=dropped, train_batch_choices=choices,
               capacity=moe_mod.capacity(B * S, cfg))
    layer = next(m for m in state.params.modules()
                 if isinstance(m, moe_mod.MoE))
    rep["ep"] = ep_full(layer, cfg, dev, B, S)
    return rep


def mamba2_full(dev, gpu: str = "", small: bool = False) -> dict:
    name = "mamba2-1.3b"
    cfg = get_config(name + "-smoke") if small else get_config(name)
    B, S = (2, 256) if small else (4, 1024)
    kw = dict(layer_remat=True, chunked_ce=True)
    rep, state = _train(cfg, dev, _ramp_batches(cfg, 3, B, S, dev),
                        gpu=gpu, **kw)
    del state
    rep["depth2_card_vs_cpu"] = _depth2(cfg, dev, 2, 32 if small else 128,
                                        chunked_ce=True)
    return rep


def run(device=None, small: bool = False, parts=PARTS, gpu: str = "",
        emit=print) -> dict:
    """Run ``parts``; emit one JSON line each; return their reports."""
    dev = resolve(device)
    _check(not torch.backends.cuda.matmul.allow_tf32,
           "TF32 is on for f32 matrix products")
    out = {}
    for part in parts:
        _free(dev)
        t0 = time.perf_counter()
        rep = {"smoke": smoke_archs, "granite": granite_full,
               "moe": moe_full, "mamba2": mamba2_full}[part](dev, gpu, small)
        rep["seconds"] = time.perf_counter() - t0
        emit(json.dumps({f"zoo_train_{part}": rep}))
        out[part] = rep
    _free(dev)
    return out


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA)")
    p.add_argument("--scale", choices=("full", "small"), default="full",
                   help="small: the smoke-size configs, for the CPU")
    p.add_argument("--parts", default=",".join(PARTS),
                   help=f"comma-separated, of {','.join(PARTS)}")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = _parse(sys.argv[1:] if argv is None else argv)
    try:
        run(args.device, args.scale == "small", args.parts.split(","))
    except ZooTrainCheckError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        raise SystemExit(1)
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    main()
