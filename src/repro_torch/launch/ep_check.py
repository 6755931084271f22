"""Expert-parallel MoE correctness check (``repro/launch/ep_check.py``).

    python -m repro_torch.launch.ep_check [n] [--device cpu]

Builds the ``deepseek-moe-16b`` smoke config (4 experts, top 2, shared
experts), draws the MoE layer's weights and B = 2, S = 4·n tokens from
seeds, and runs the tokens through ``moe_forward`` and through the
expert-parallel path with M = n ranks, both at capacity factor 8.0 (no
choice dropped, so the two must agree).  With ``--device cpu`` the ranks
are n spawned processes in a gloo group (the exchanges are
``all_to_all_single``); on CUDA they run in lock step on one card.
Prints the reference's JSON line (``max_abs_diff``, ``max_rel_diff``,
``aux_single``, ``aux_ep``, ``agree``) plus ``form``; the gloo run adds
``forms_equal``, rank 0's lock-step output against the group's, which
must be equal bit for bit, and ``grads_rel``, the group's gradients
(summed over the ranks) against the lock-step form's, which must be
within 1e-5 of each gradient's largest |value|.  Exits non-zero unless
they agree.

The gloo group meets through a ``file://`` store in a temporary
directory, so concurrent runs never share a port.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["moe_inputs", "probe", "gloo_forward", "run"]

CAPACITY_FACTOR = 8.0


def moe_inputs(n: int, device="cpu"):
    """(cfg, MoE module, x (2, 4n, d)) from seeds 0 (weights) and 1 (x)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    cfg = get_config("deepseek-moe-16b").smoke()
    dev = torch.device(device)
    p = moe_mod.MoE(torch.Generator(device=dev).manual_seed(0), cfg,
                    torch.float32, dev)
    x = np.random.default_rng(1).standard_normal(
        (2, 4 * n, cfg.d_model)).astype(np.float32)
    return cfg, p, torch.as_tensor(x, device=dev)


def probe(y: torch.Tensor) -> torch.Tensor:
    """Fixed weights for a scalar of y whose gradient reaches every
    token: normal draws from seed 2, y's shape."""
    g = torch.Generator().manual_seed(2)
    return torch.randn(y.shape, generator=g).to(y.device)


def _grads(ep, p, x):
    """(y, aux, the gradients of (y·probe).sum() + aux by x and by each
    weight of p)."""
    x = x.detach().requires_grad_(True)
    y, aux = ep(p, x)
    named = dict(p.named_parameters())
    got = torch.autograd.grad((y * probe(y)).sum() + aux,
                              [x, *named.values()])
    return y.detach(), aux.detach(), dict(zip(["x", *named], got))


def _rank_main(rank: int, n: int, store: str, inputs: str, out: str,
               capacity_factor: float) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch.ep import make_ep_ctx
    from repro_torch.models import moe as moe_mod
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    try:
        saved = torch.load(inputs)
        cfg = get_config(saved["cfg"])
        p = moe_mod.MoE(torch.Generator(), cfg, torch.float32,
                        torch.device("meta")).to_empty(device="cpu")
        p.load_state_dict(saved["p"])
        p.requires_grad_(True)
        ep = make_ep_ctx(n, cfg, group=dist.group.WORLD,
                         capacity_factor=capacity_factor)
        y, aux, grads = _grads(ep, p, saved["x"])
        for k, g in grads.items():       # a weight's gradient is a sum
            if k != "x":                 # over the ranks' tokens
                dist.all_reduce(g)
        if rank == 0:
            # the lock-step form under the same thread count
            y_b, aux_b, grads_b = _grads(
                make_ep_ctx(n, cfg, capacity_factor=capacity_factor),
                p, saved["x"])
            torch.save({"y": y, "aux": aux, "grads": grads,
                        "y_lockstep": y_b, "aux_lockstep": aux_b,
                        "grads_lockstep": grads_b}, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def gloo_forward(cfg_name: str, p_state: dict, x: torch.Tensor, n: int,
                 capacity_factor: float = CAPACITY_FACTOR) -> dict:
    """Run the gloo form on n spawned CPU processes, each one rank, on
    the MoE weights ``p_state`` (a state dict) and tokens x (B, S, d),
    forward and backward.  Returns rank 0's ``{"y", "aux", "grads"}``
    (``grads``: of (y·probe).sum() + aux by x and by each weight, summed
    over the ranks) and the same from the lock-step form under
    ``*_lockstep`` keys."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        inputs, out = os.path.join(tmp, "in.pt"), os.path.join(tmp, "out.pt")
        torch.save({"cfg": cfg_name, "p": p_state, "x": x.cpu()}, inputs)
        mp.start_processes(_rank_main, args=(n, os.path.join(tmp, "store"),
                                             inputs, out, capacity_factor),
                           nprocs=n, join=True, start_method="spawn")
        return torch.load(out)


def run(n: int = 4, device=None) -> dict:
    """The check's report; the gloo form when ``device`` is the CPU."""
    from repro_torch._device import resolve
    from repro_torch.launch.ep import make_ep_ctx
    from repro_torch.models import moe as moe_mod
    dev = resolve(device)
    cfg, p, x = moe_inputs(n, dev)
    ep = make_ep_ctx(n, cfg, capacity_factor=CAPACITY_FACTOR)
    if ep is None:
        raise ValueError(f"EP not engaged: {cfg.num_experts} experts over "
                         f"{n} ranks")
    with torch.no_grad():
        y_single, aux_single = moe_mod.moe_forward(
            p, cfg, x, capacity_factor=CAPACITY_FACTOR)
        rep = {"n_devices": n}
        if dev.type == "cpu":
            got = gloo_forward(cfg.name, p.state_dict(), x, n)
            y_ep, aux_ep = got["y"], got["aux"]
            rep.update(form="gloo", forms_equal=bool(
                torch.equal(got["y"], got["y_lockstep"])
                and torch.equal(got["aux"], got["aux_lockstep"])),
                grads_rel=max(_rel(got["grads"][k], g) for k, g in
                              got["grads_lockstep"].items()))
        else:
            y_ep, aux_ep = ep(p, x)
            rep["form"] = "lockstep"
    diff = float((y_single - y_ep.to(dev)).abs().max())
    rel = diff / float(y_single.abs().max())
    rep.update(max_abs_diff=diff, max_rel_diff=rel,
               aux_single=float(aux_single), aux_ep=float(aux_ep),
               agree=rel < 1e-4 and rep.get("forms_equal", True)
               and rep.get("grads_rel", 0.0) < 1e-5)
    return rep


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; cpu: gloo ranks)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    rep = run(args.n, args.device)
    print(json.dumps(rep))
    if not rep["agree"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
