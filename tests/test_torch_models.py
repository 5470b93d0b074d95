"""The port's worker-stacked models against the flax models of the JAX
package, with the JAX package's weights carried over by ``convert.py``.

The port stacks the workers as convolution groups (one ``groups=N`` conv
per layer, batch norm over ``N·C`` channels, a batched head) where the JAX
package vmaps one flax model; the semantics are per worker on both sides.

Tolerances: logits 1e-5 relative plus 1e-5 absolute (tens of convolution
sums of a few hundred terms each, summed in another order on each side;
train-mode batch norm divides by a small batch's spread).  Running
statistics 1e-5.  Gradients 1e-4 relative plus 1e-5 absolute: the
backward pass sums over the batch and the spatial map once more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    flatten_like_port,
    images,
    jax_worker_variables,
    load_into_port,
    stats_like_port,
    to_numpy,
)
from matcha_tpu.models import select_model as jax_select_model
from matcha_tpu.utils import cross_entropy_loss as jax_cross_entropy
from matcha_tpu_torch.models import select_model
from matcha_tpu_torch.ops import WorkerFlattener
from matcha_tpu_torch.utils import cross_entropy_loss, top_k_accuracy

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(name, workers, seed=0):
    jmodel = jax_select_model(name, "synthetic_image")
    params, stats = jax_worker_variables(jmodel, (32, 32, 3), workers, seed)
    pmodel = select_model(name, "synthetic_image", num_workers=workers)
    load_into_port(pmodel, params, stats)
    return jmodel, pmodel, params, stats


def _jax_forward(jmodel, params, stats, x, train):
    def one(p, s, xb):
        variables = {"params": p, "batch_stats": s}
        if train:
            return jmodel.apply(variables, xb, train=True,
                                mutable=["batch_stats"])
        return jmodel.apply(variables, xb, train=False), {}

    logits, mutated = jax.jit(jax.vmap(one))(params, stats, jnp.asarray(x))
    return np.asarray(logits), to_numpy(mutated.get("batch_stats", {}))


@pytest.fixture(scope="module")
def resnet8():
    return _pair("resnet8", workers=3, seed=1)


@pytest.fixture(scope="module")
def resnet20():
    return _pair("resnet20", workers=2, seed=2)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("depth", ["resnet8", "resnet20"])
def test_resnet_logits_and_bn_statistics_match_flax(request, depth, train):
    jmodel, pmodel, params, stats = request.getfixturevalue(depth)
    x, _ = images(pmodel.num_workers, 6, seed=3)
    ref, new_stats = _jax_forward(jmodel, params, stats, x, train)
    load_into_port(pmodel, params, stats)
    pmodel.train(train)
    with torch.no_grad():
        out = pmodel(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (pmodel.num_workers, 6, 10)
    np.testing.assert_allclose(out, ref, **LOGIT_TOL)
    buffers = {k: v.numpy() for k, v in pmodel.named_buffers()}
    # train mode moves the running statistics flax's way: momentum 0.9 on
    # the biased batch variance; eval mode leaves them untouched
    want = stats_like_port(new_stats) if train else stats_like_port(stats)
    assert set(buffers) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(buffers[name], value, rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_bn_keeps_the_biased_running_variance(resnet8):
    # a torch BatchNorm2d would store the unbiased variance, n/(n-1) larger
    _, pmodel, params, stats = resnet8
    load_into_port(pmodel, params, stats)
    pmodel.train()
    x = torch.from_numpy(images(pmodel.num_workers, 2, seed=4)[0])
    with torch.no_grad():
        pmodel(x)
        stem = x.permute(1, 0, 4, 2, 3).reshape(2, -1, 32, 32)
        h = pmodel.stem(stem)
    biased = h.var(dim=(0, 2, 3), unbiased=False).reshape(-1, 16)
    np.testing.assert_allclose(pmodel.stem_bn.running_var.numpy(),
                               (0.9 + 0.1 * biased).numpy(), rtol=1e-5)


def test_resnet8_gradients_match_flax(resnet8):
    jmodel, pmodel, params, stats = resnet8
    x, y = images(pmodel.num_workers, 6, seed=5)

    def loss(p, s, xb, yb):
        logits, _ = jmodel.apply({"params": p, "batch_stats": s}, xb,
                                 train=True, mutable=["batch_stats"])
        return jax_cross_entropy(logits, yb)

    grads = jax.jit(jax.vmap(jax.grad(loss)))(params, stats, jnp.asarray(x),
                                              jnp.asarray(y))
    ref = flatten_like_port(to_numpy(grads))
    load_into_port(pmodel, params, stats)
    pmodel.train()
    pmodel.zero_grad(set_to_none=True)
    losses = cross_entropy_loss(pmodel(torch.from_numpy(x)),
                                torch.from_numpy(y))
    # the sum of the per-worker means: each worker gets its own gradient
    losses.sum().backward()
    got = {k: p.grad.numpy() for k, p in pmodel.named_parameters()}
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], **GRAD_TOL,
                                   err_msg=name)


def test_parameter_count_and_tree_order(resnet20):
    _, pmodel, params, _ = resnet20
    flat = WorkerFlattener(dict(pmodel.named_parameters()))
    assert flat.dim == 273258  # ResNet-20, 10 classes, per worker
    # leaf k of the port is leaf k of the JAX tree (flax's sorted keys)
    jax_leaves = jax.tree_util.tree_leaves(params)
    assert [int(np.prod(a.shape[1:])) for a in jax_leaves] == flat.sizes


@pytest.mark.parametrize("name", ["mlp", "resnet8"])
def test_select_model_shapes(name):
    model = select_model(name, "synthetic", num_workers=2)
    x = torch.zeros((2, 3, 28, 28, 1))
    assert model(x).shape == (2, 3, 10)


def test_select_model_refuses_unported_models():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        select_model("vgg16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        select_model("resnet18", "imagenet")
    with pytest.raises(KeyError):
        select_model("transformer")


def test_metrics_match_jax():
    from matcha_tpu.utils import top_k_accuracy as jax_top_k

    rng = np.random.default_rng(6)
    logits = rng.normal(size=(3, 16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, size=(3, 16)).astype(np.int32)
    np.testing.assert_allclose(
        cross_entropy_loss(torch.from_numpy(logits),
                           torch.from_numpy(labels)).numpy(),
        np.asarray(jax_cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(labels))), rtol=1e-6)
    for k in (1, 3):
        np.testing.assert_array_equal(
            top_k_accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                           k=k).numpy(),
            np.asarray(jax_top_k(jnp.asarray(logits), jnp.asarray(labels),
                                 k=k)))
