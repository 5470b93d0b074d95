"""Helpers shared by the port's parity tests: JAX worker-stacked variables
made the JAX package's way, carried into the port with ``convert.py``."""

import jax
import jax.numpy as jnp
import numpy as np


def to_numpy(tree):
    """A (nested) mapping of arrays as plain dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_worker_variables(model, input_shape, num_workers, seed=0):
    """``(params, batch_stats)`` with a leading worker axis, each worker
    initialized from its own key, as ``init_train_state`` does."""
    dummy = jnp.zeros((1,) + tuple(input_shape), jnp.float32)

    def init_one(key):
        variables = model.init(key, dummy, train=False)
        return variables["params"], variables.get("batch_stats", {})

    keys = jax.random.split(jax.random.PRNGKey(seed), num_workers)
    params, stats = jax.vmap(init_one)(keys)
    return to_numpy(params), to_numpy(stats)


def load_into_port(model, params, batch_stats):
    """Load JAX variables into a port model (strict: every name maps)."""
    import torch

    from matcha_tpu_torch.convert import params_from_jax

    p, b = params_from_jax(params, batch_stats)
    model.load_state_dict({**p, **b}, strict=True)
    return model.to(torch.float32)


def flatten_like_port(tree):
    """A JAX tree flattened to ``{port name: [N, ...] numpy}``."""
    from matcha_tpu_torch.convert import params_from_jax

    return {k: v.numpy() for k, v in params_from_jax(tree)[0].items()}


def stats_like_port(tree):
    from matcha_tpu_torch.convert import params_from_jax

    return {k: v.numpy() for k, v in params_from_jax({}, tree)[1].items()}


def images(num_workers, batch, seed=0, shape=(32, 32, 3)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(num_workers, batch) + shape).astype(np.float32)
    y = rng.integers(0, 10, size=(num_workers, batch)).astype(np.int32)
    return x, y
