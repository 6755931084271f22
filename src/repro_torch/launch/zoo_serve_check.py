"""The model zoo's serving path on a device, checked against itself and
against the CPU (phase (i) of ``chip_smoke.py``).

Four parts, each printing one JSON line and raising
:class:`ZooCheckError` on the first check that fails:

* ``smoke``: all ten archs at ``.smoke()`` size, weights drawn on the
  device from a seeded ``torch.Generator`` and copied to the CPU.  Logits
  on the device within ``TOL`` of the CPU's; for the causal archs, a
  prefill plus one decode step within ``DECODE_TOL`` of the full forward
  on the device, and ``generate`` giving the same tokens on both devices
  (each row up to its first step whose top-2 margin is within twice the
  largest logit difference seen, the rest counted).
* ``qwen3``: ``qwen3-8b`` at full width and depth in f32, ``generate`` on
  8 prompts of 1 to 990 tokens, 32 new tokens each, so every prompt plus
  its tokens stays within one attention query chunk (1,024).  Checked
  teacher-forced: one forward over each prompt plus its tokens gives the
  generated token at every generated position whose margin exceeds twice
  the largest difference between those logits and the decode steps'.
  Then the card against the CPU at full width, depth cut to 2 (those
  layers' weights copied to the host), on one 32-token prompt.
* ``moe``: ``deepseek-moe-16b`` at full width, depth cut to 4 (the dense
  first layer and 3 MoE layers), ``generate`` for 64 prompts; the choices
  dropped by capacity in the prefill and the decode are counted (at
  decode, 384 choices over 64 experts of capacity 8), and the first MoE
  layer's first decode step is held against the CPU.
* ``mamba2``: ``mamba2-1.3b`` at full width and depth, 8 prompts of 1 to
  224 tokens and 32 new tokens, so the prefill and the teacher-forced
  forward stay within one SSD chunk (256).  The engine, like the
  reference's, runs the SSM state through the padded prompt rectangle and
  the last prompt token again; the teacher-forced sequence is the one the
  state saw: the padded prompt, its last token, then the generated ones.

TF32 stays off (PyTorch's default for f32 matrix products), so the card
multiplies in full f32 as the CPU does.  ``--scale small`` runs the same
code on the smoke-size configs, for a rehearsal on the CPU.

    python -m repro_torch.launch.zoo_serve_check --device cpu --scale small

Prints one JSON line a part and last ``{"ok": ...}``; exits non-zero
unless every check passes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer
from repro_torch.models.attention import Q_CHUNK
from repro_torch.models.layers import softcap
from repro_torch.models.ssm import CHUNK
from repro_torch.serve.engine import generate
from repro_torch.serve.serve_step import decode_step, init_cache, prefill

__all__ = ["ZooCheckError", "smoke_arch", "smoke_archs", "qwen3_full",
           "moe_full", "mamba2_full", "run"]

#: Logits of two devices or packages: max |diff| over the largest |logit|.
TOL = 1e-4
#: Prefill plus decode against the full forward (the reference's own).
DECODE_TOL = 2e-3
SEED = 0
PARTS = ("smoke", "qwen3", "moe", "mamba2")


class ZooCheckError(AssertionError):
    """A zoo serving check failed."""


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ZooCheckError(msg)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    diff = (got.float().to(want.device) - want).abs().max()
    return float(diff / want.abs().max().clamp_min(1e-30))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _generator(dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(SEED)


def _cpu_copy(model, cfg):
    """The same weights on the CPU."""
    cpu = transformer.empty_params(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    return cpu


def _batch(cfg, B: int, S: int, r: np.random.Generator, dev) -> dict:
    if cfg.modality == "audio_frames":
        return {"frames": torch.as_tensor(r.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32), device=dev)}
    out = {"tokens": torch.as_tensor(
        r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32), device=dev)}
    if cfg.modality == "image_patches":
        out["patches"] = torch.as_tensor(r.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32),
            device=dev)
    return out


def _same_tokens(a: list, b: list, step_a: list, step_b: list) -> dict:
    """Two devices' ``generate`` tokens: equal in each row up to the first
    step where they part, and there the top-2 margin must be within twice
    the largest logit difference seen up to the parting steps."""
    la, lb = torch.stack(step_a, 1).float().cpu(), \
        torch.stack(step_b, 1).float().cpu()
    n = la.shape[1]
    part = [next((t for t, (x, y) in enumerate(zip(ra, rb)) if x != y), n)
            for ra, rb in zip(a, b)]
    diff = max(float((la[i, :min(t + 1, n)] - lb[i, :min(t + 1, n)]).abs()
                     .max()) for i, t in enumerate(part))
    top2 = la.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    for i, t in enumerate(part):
        if t < n:
            _check(float(margin[i, t]) <= 2 * diff,
                   f"row {i} parts at step {t} with margin "
                   f"{float(margin[i, t]):.3g} > 2 × {diff:.3g}")
    return {"steps_compared": sum(part), "steps": n * len(a),
            "max_abs_diff": diff,
            "rel": diff / float(la.abs().max().clamp_min(1e-30))}


def _teacher_forced(model, cfg, seqs: list, at: list, tokens: list,
                    step_logits: list, dev) -> dict:
    """One forward over the right-padded ``seqs``; the logits at positions
    ``at[i]`` must pick ``tokens[i]`` wherever their top-2 margin exceeds
    twice their largest difference from ``step_logits`` (the decode
    steps' logits, (B, V) each)."""
    L = max(len(s) for s in seqs)
    rect = np.zeros((len(seqs), L), np.int32)
    for i, s in enumerate(seqs):
        rect[i, :len(s)] = s
    with torch.inference_mode():
        hidden, _, _ = transformer.forward(
            model, cfg, {"tokens": torch.as_tensor(rect, device=dev)},
            return_hidden=True)
        idx = torch.as_tensor(np.array(at), device=dev)
        rows = torch.arange(len(seqs), device=dev)[:, None]
        tf = softcap(hidden[rows, idx] @ transformer.head_weight(model),
                     cfg.final_logit_softcap).float()
    step = torch.stack(step_logits, 1).float()
    diff = float((tf - step).abs().max())
    rel = diff / float(step.abs().max().clamp_min(1e-30))
    top2 = tf.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    want = torch.as_tensor(np.array(tokens), device=dev)
    guarded = margin > 2 * diff
    wrong = int(((tf.argmax(-1) != want) & guarded).sum())
    _check(rel <= DECODE_TOL, f"decode steps differ from the forward by "
           f"{rel:.3g} of the largest logit (> {DECODE_TOL})")
    _check(wrong == 0, f"{wrong} teacher-forced tokens differ")
    return {"positions": int(want.numel()),
            "under_guard": int((~guarded).sum()), "mismatched": wrong,
            "max_abs_diff": diff, "rel": rel}


def _lengths(lo: int, hi: int, n: int) -> list:
    return [int(v) for v in np.linspace(lo, hi, n).round()]


def _prompts(lengths: list, vocab: int, r: np.random.Generator) -> list:
    return [r.integers(0, vocab, n).tolist() for n in lengths]


def _serve_report(cfg, model, prompts, n_new, timings, seconds) -> dict:
    steps = np.array(timings["step_ms"])
    return {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "prompts": len(prompts),
        "prompt_lens": [min(len(p) for p in prompts),
                        max(len(p) for p in prompts)],
        "new_tokens": n_new,
        "weight_bytes": sum(p.numel() * p.element_size()
                            for p in model.parameters()),
        "prefill_ms": timings["prefill_ms"],
        "decode_ms_p50": float(np.percentile(steps, 50)),
        "decode_ms_p99": float(np.percentile(steps, 99)),
        "generate_s": seconds,
        "tokens_per_s": len(prompts) * n_new / seconds,
    }


def _timed_generate(model, cfg, prompts, n_new, dev, **kw):
    steps, timings = [], {}
    _sync(dev)
    t0 = time.perf_counter()
    out = generate(model, cfg, prompts, max_new_tokens=n_new, device=dev,
                   step_logits=steps, timings=timings, **kw)
    _sync(dev)
    seconds = time.perf_counter() - t0
    _check(all(len(o) == n_new for o in out), "a row stopped early")
    _check(all(0 <= t < cfg.vocab_size for o in out for t in o),
           "a token lies outside the vocabulary")
    return out, steps, timings, seconds


def _profile_decode(model, cfg, prompts, dev, n: int = 4) -> dict:
    """``n`` decode steps after a prefill of ``prompts``, under
    ``torch.profiler``: wall and device ms a step, kernels a step, the
    device's busy share, and the three kernels that took the most device
    time.  Empty off CUDA."""
    if dev.type != "cuda":
        return {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B, L = len(prompts), max(len(p) for p in prompts)
    rect = np.zeros((B, L), np.int32)
    for i, p in enumerate(prompts):
        rect[i, :len(p)] = p
    cache = init_cache(cfg, B, L + n + 1, device=dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    prefill(model, cfg, {"tokens": torch.as_tensor(rect, device=dev),
                         "pos": zeros}, cache)
    tok = torch.as_tensor(rect[:, -1:], device=dev)
    decode_step(model, cfg, tok, zeros + L, cache)         # warm
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = time.perf_counter()
        for t in range(n):
            tok = decode_step(model, cfg, tok, zeros + L + 1 + t, cache)[0]
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - wall) * 1e3
    # the device's own events only: a CPU op's device time is its
    # kernels' time again
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {"profiled_steps": n, "wall_ms_a_step": wall / n,
            "device_ms_a_step": device_ms / n,
            "kernels_a_step": n_kernels / n,
            "device_busy_share": device_ms / wall,
            "top_kernels_ms_a_step": {k[:60]: v / n for k, v in top}}


def _peak(dev) -> dict:
    if dev.type != "cuda":
        return {}
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(dev)}


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


# ------------------------------------------------------------------ parts
def smoke_arch(name: str, dev) -> dict:
    """One arch at smoke size on ``dev`` against the CPU copy of its
    weights."""
    cfg = get_config(name + "-smoke")
    r = np.random.default_rng(SEED)
    model = transformer.init_params(cfg, _generator(dev), device=dev)
    cpu = _cpu_copy(model, cfg)
    B, S = 2, 32
    batch = _batch(cfg, B, S, r, dev)
    with torch.inference_mode():
        got, _, _ = transformer.forward(model, cfg, batch)
        want, _, _ = transformer.forward(
            cpu, cfg, {k: v.cpu() for k, v in batch.items()})
    rep = {"forward_rel": _rel(got, want)}
    _check(rep["forward_rel"] <= TOL,
           f"{name}: logits on {dev} differ from the CPU's by "
           f"{rep['forward_rel']:.3g}")
    if not cfg.causal:
        return rep
    front = cfg.frontend_tokens if "patches" in batch else 0
    cache = init_cache(cfg, B, front + S + 4, device=dev)
    pre = dict(batch, tokens=batch["tokens"][:, :S - 1],
               pos=torch.zeros(B, dtype=torch.int32, device=dev))
    prefill(model, cfg, pre, cache)
    _, dec, _ = decode_step(
        model, cfg, batch["tokens"][:, S - 1:],
        torch.full((B,), front + S - 1, dtype=torch.int32, device=dev),
        cache)
    rep["decode_rel"] = _rel(dec[:, 0], got[:, -1])
    _check(rep["decode_rel"] <= DECODE_TOL,
           f"{name}: decode differs from the forward by "
           f"{rep['decode_rel']:.3g}")
    prompts = _prompts([3, 11, 1, 7], cfg.vocab_size, r)
    steps_d, steps_c = [], []
    toks_d = generate(model, cfg, prompts, max_new_tokens=8, device=dev,
                      step_logits=steps_d)
    toks_c = generate(cpu, cfg, prompts, max_new_tokens=8, device="cpu",
                      step_logits=steps_c)
    rep["generate"] = _same_tokens(toks_d, toks_c, steps_d, steps_c)
    rep["generate_equal"] = toks_d == toks_c
    return rep


def smoke_archs(dev, small: bool = False) -> dict:
    """All ten archs at smoke size on ``dev`` against the CPU."""
    return {name: smoke_arch(name, dev) for name in sorted(ARCHS)}


def qwen3_full(dev, gpu: str = "", small: bool = False) -> dict:
    name = "qwen3-8b"
    cfg = get_config(name + "-smoke") if small else get_config(name)
    lengths = _lengths(1, 40 if small else 990, 8)
    n_new = 4 if small else 32
    assert max(lengths) + n_new <= Q_CHUNK
    r = np.random.default_rng(SEED)
    _reset_peak(dev)
    t0 = time.perf_counter()
    model = transformer.init_params(cfg, _generator(dev), device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    prompts = _prompts(lengths, cfg.vocab_size, r)
    toks, steps, timings, seconds = _timed_generate(model, cfg, prompts,
                                                    n_new, dev)
    rep = _serve_report(cfg, model, prompts, n_new, timings, seconds)
    rep.update(_peak(dev), init_s=init_s, gpu=gpu, dtype="float32",
               tf32=torch.backends.cuda.matmul.allow_tf32)
    seqs = [p + t for p, t in zip(prompts, toks)]
    at = [[len(p) - 1 + t for t in range(n_new)] for p in prompts]
    rep["teacher_forced"] = _teacher_forced(model, cfg, seqs, at, toks,
                                            steps, dev)
    del steps
    rep["decode_profile"] = _profile_decode(model, cfg, prompts, dev)
    # card against CPU: full width, the first two layers
    cut = dataclasses.replace(cfg, num_layers=2)
    keep = {k: v for k, v in model.state_dict().items()
            if not k.startswith("segments.") or int(k.split(".")[2]) < 2}
    del model
    _reset_peak(dev)
    two = transformer.empty_params(cut, device=dev)
    two.load_state_dict(keep)
    cpu = transformer.empty_params(cut, device="cpu")
    cpu.load_state_dict(keep)
    del keep
    tok = torch.as_tensor(r.integers(0, cfg.vocab_size, (1, 32)).astype(
        np.int32))
    with torch.inference_mode():
        got, _, _ = transformer.forward(two, cut, {"tokens": tok.to(dev)})
        want, _, _ = transformer.forward(cpu, cut, {"tokens": tok})
    rep["depth2_card_vs_cpu_rel"] = _rel(got, want)
    _check(rep["depth2_card_vs_cpu_rel"] <= TOL,
           f"{name}: depth-2 logits differ from the CPU's by "
           f"{rep['depth2_card_vs_cpu_rel']:.3g}")
    return rep


class _Drops:
    """Counts the MoE choices dropped by capacity, by a forward pre-hook
    on every MoE layer (the routing recomputed on the layer's input), and
    keeps the first MoE layer's first decode-step input."""

    def __init__(self, model):
        self.counts = {"prefill": [0, 0], "decode": [0, 0]}
        self.first_decode = None
        self.handles = [m.register_forward_pre_hook(self._hook)
                        for m in model.modules()
                        if isinstance(m, moe_mod.MoE)]

    def _hook(self, mod, args):
        x = args[0]
        xf = x.reshape(-1, x.shape[-1])
        cap = moe_mod.capacity(xf.shape[0], mod.cfg)
        _, experts, _ = moe_mod.route(mod, mod.cfg, xf)
        keep = moe_mod.dispatch_indices(experts, mod.cfg.num_experts, cap)[2]
        kind = "prefill" if x.shape[1] > 1 else "decode"
        self.counts[kind][0] += int((~keep).sum())
        self.counts[kind][1] += keep.numel()
        if kind == "decode" and self.first_decode is None:
            self.first_decode = (mod, x.clone(), cap)

    def remove(self):
        for h in self.handles:
            h.remove()


def moe_full(dev, gpu: str = "", small: bool = False) -> dict:
    name = "deepseek-moe-16b"
    full = get_config(name + "-smoke") if small else get_config(name)
    cfg = dataclasses.replace(full, num_layers=2 if small else 4)
    n_prompts, n_new = (16, 4) if small else (64, 8)
    r = np.random.default_rng(SEED)
    _reset_peak(dev)
    model = transformer.init_params(cfg, _generator(dev), device=dev)
    prompts = _prompts([int(v) for v in r.integers(1, 65, n_prompts)],
                       cfg.vocab_size, r)
    drops = _Drops(model)
    try:
        toks, steps, timings, seconds = _timed_generate(model, cfg, prompts,
                                                        n_new, dev)
    finally:
        drops.remove()
    rep = _serve_report(cfg, model, prompts, n_new, timings, seconds)
    rep.update(_peak(dev), gpu=gpu, dtype="float32",
               reduced={"num_layers": [full.num_layers, cfg.num_layers]},
               experts=cfg.num_experts, top_k=cfg.experts_per_token,
               shared_experts=cfg.num_shared_experts,
               decode_capacity=moe_mod.capacity(n_prompts, cfg))
    for kind, (dropped, choices) in drops.counts.items():
        rep[f"{kind}_dropped"], rep[f"{kind}_choices"] = dropped, choices
    _check(rep["decode_dropped"] > 0, "no choice dropped at decode")
    _check(all(bool(torch.isfinite(s).all()) for s in steps),
           "non-finite logits")
    rep["decode_profile"] = _profile_decode(model, cfg, prompts, dev)
    # the first MoE layer's first decode step against the CPU
    mod, x, cap = drops.first_decode
    cpu = moe_mod.MoE(torch.Generator(), cfg, torch.float32,
                      torch.device("meta")).to_empty(device="cpu")
    cpu.load_state_dict(mod.state_dict())
    with torch.inference_mode():
        xf = x.reshape(-1, cfg.d_model)
        got_e = moe_mod.route(mod, cfg, xf)[1]
        want_e = moe_mod.route(cpu, cfg, xf.cpu())[1]
        _check(torch.equal(got_e.cpu(), want_e),
               "the chosen experts differ from the CPU's")
        for g, w in zip(moe_mod.dispatch_indices(got_e, cfg.num_experts, cap),
                        moe_mod.dispatch_indices(want_e, cfg.num_experts,
                                                 cap)):
            _check(torch.equal(g.cpu(), w), "the dispatch differs")
        got, _ = mod(x)
        want, _ = cpu(x.cpu())
    rep["decode_layer_card_vs_cpu_rel"] = _rel(got, want)
    _check(rep["decode_layer_card_vs_cpu_rel"] <= TOL,
           f"the MoE layer differs from the CPU's by "
           f"{rep['decode_layer_card_vs_cpu_rel']:.3g}")
    return rep


def mamba2_full(dev, gpu: str = "", small: bool = False) -> dict:
    name = "mamba2-1.3b"
    cfg = get_config(name + "-smoke") if small else get_config(name)
    n_new = 4 if small else 32
    lengths = _lengths(1, 28 if small else 224, 8)
    max_len = max(lengths)
    assert max_len + n_new <= CHUNK
    r = np.random.default_rng(SEED)
    _reset_peak(dev)
    model = transformer.init_params(cfg, _generator(dev), device=dev)
    prompts = _prompts(lengths, cfg.vocab_size, r)
    toks, steps, timings, seconds = _timed_generate(model, cfg, prompts,
                                                    n_new, dev)
    rep = _serve_report(cfg, model, prompts, n_new, timings, seconds)
    rep.update(_peak(dev), gpu=gpu, dtype="float32")
    # the sequence the SSM state saw: the padded prompt, its last token
    # again, then the generated tokens
    seqs = [p + [0] * (max_len - len(p)) + [p[-1]] + t[:-1]
            for p, t in zip(prompts, toks)]
    at = [[max_len + t for t in range(n_new)] for _ in prompts]
    rep["teacher_forced"] = _teacher_forced(model, cfg, seqs, at, toks,
                                            steps, dev)
    rep["decode_profile"] = _profile_decode(model, cfg, prompts, dev)
    return rep


def run(device=None, small: bool = False, parts=PARTS, gpu: str = "",
        emit=print) -> dict:
    """Run ``parts``; emit one JSON line each; return their reports."""
    dev = resolve(device)
    _check(not torch.backends.cuda.matmul.allow_tf32,
           "TF32 is on for f32 matrix products")
    out = {}
    for part in parts:
        t0 = time.perf_counter()
        if part == "smoke":
            rep = smoke_archs(dev, small)
        else:
            rep = {"qwen3": qwen3_full, "moe": moe_full,
                   "mamba2": mamba2_full}[part](dev, gpu, small)
        rep["seconds"] = time.perf_counter() - t0
        emit(json.dumps({f"zoo_{part}": rep}))
        out[part] = rep
        if dev.type == "cuda":
            torch.cuda.empty_cache()
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
    except ZooCheckError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        raise SystemExit(1)
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    main()
