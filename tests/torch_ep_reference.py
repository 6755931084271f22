"""The reference's expert-parallel MoE on fake XLA CPU devices, as a
subprocess for ``tests/test_torch_ep.py``:

    python tests/torch_ep_reference.py OUT.npz [n_devices]

Runs ``repro.launch.ep.make_ep_ctx`` (``moe_forward_ep`` under
``shard_map``, two all-to-alls) and ``moe_forward`` at capacity factor 8.0
on the ``deepseek-moe-16b`` smoke config, B = 2, S = 4·n, weights from
``moe_init(key(0))`` and x from ``normal(key(1))``, as
``repro/launch/ep_check.py`` does.  Writes x, the weights (``p/<path>``),
``y_ep``, ``aux_ep``, ``y_single`` and ``aux_single`` to OUT.npz.  The
device count is set before jax is imported, so this runs in a process of
its own.
"""
import os
import sys


def main() -> None:
    out = sys.argv[1]
    n_dev = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_dev} "
        + os.environ.get("XLA_FLAGS", ""))

    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs import get_config
    from repro.launch.ep import make_ep_ctx
    from repro.models import moe as moe_mod

    cfg = get_config("deepseek-moe-16b").smoke()
    mesh = jax.make_mesh((1, n_dev), ("data", "model"))
    p = moe_mod.moe_init(jax.random.key(0), cfg)
    x = jax.random.normal(jax.random.key(1), (2, 4 * n_dev, cfg.d_model))
    y_single, aux_single = jax.jit(lambda p, x: moe_mod.moe_forward(
        p, cfg, x, capacity_factor=8.0))(p, x)
    ep_ctx = make_ep_ctx(mesh, cfg, capacity_factor=8.0)
    assert ep_ctx is not None, "EP not engaged"
    with mesh:
        x_sh = jax.device_put(x, NamedSharding(mesh, P("data", "model",
                                                       None)))
        y_ep, aux_ep = jax.jit(lambda p, x: ep_ctx(p, x))(p, x_sh)
    flat = {"p/" + "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    np.savez(out, x=np.asarray(x), y_ep=np.asarray(y_ep),
             aux_ep=np.asarray(aux_ep), y_single=np.asarray(y_single),
             aux_single=np.asarray(aux_single), **flat)


if __name__ == "__main__":
    main()
