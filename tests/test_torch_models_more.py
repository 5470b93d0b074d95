"""The port's VGG, WideResNet and ImageNet ResNet against the flax models of
the JAX package, with the JAX weights carried over by ``convert.py``
(``load_state_dict(strict=True)``: every name maps); the registry's
aliases; and the two memory knobs, ``remat`` and ``grad_chunk``.

Sizes: VGG-11 and WRN-10-2 on CIFAR-shaped 32×32 inputs, the ImageNet
ResNet-18 on 64×64 inputs (its stem, pool and strides take them to 2×2),
2 workers, batch 3, 10 classes.  The full-width configurations (VGG-16, WRN-28-10,
ResNet-50) are checked by shape only, through ``jax.eval_shape``.

Tolerances, and why:

* The forward in float32: logits 1e-5 relative plus 1e-5 of the largest
  logit (eight to twenty conv layers, each a sum of hundreds of terms in
  another order on each side, and train-mode batch norm dividing by a
  3-image batch's spread; measured at most 6e-6 of the largest), running
  statistics 1e-5 relative plus 1e-6 absolute.
* Gradients in float64 on both sides: in float32 a ReLU pre-activation
  within an ulp of 0 flips its mask on one side only and moves every
  earlier layer's gradient at the percent level
  (``tests/test_torch_train.py``).  The JAX models compute their head in
  float32 whatever their dtype (flax ``Dense(dtype=float32)``), so one
  float32 rounding of the logits still reaches every gradient:
  ``|Δ| ≤ 1e-4·|g| + 1e-5·max|g|``, the max over the whole model
  (measured at most 6.4e-7 of it).
* ``remat`` recomputes the same operations on the same inputs on the CPU:
  on and off are compared bitwise.
* ``grad_chunk`` runs convolutions of other group counts, whose sums (of
  3,072 terms for a 3×3 weight's gradient here) PyTorch may order
  otherwise: ``|Δ| ≤ 1e-5·|v| + 1e-5·max|v|`` after one step, the max
  over the tensors of the same kind (parameters, gradients or statistics;
  a conv bias before a batch norm has a gradient of rounding noise).
"""

import dataclasses

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
from matcha_tpu_torch.communicator import make_none
from matcha_tpu_torch.models import (
    ResNetImageNet,
    init_workers,
    resnet_imagenet_config,
    select_model,
    vgg_config,
)
from matcha_tpu_torch.ops import WorkerFlattener
from matcha_tpu_torch.train import (
    TrainConfig,
    init_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    train,
)
from matcha_tpu_torch.utils import cross_entropy_loss

STAT_TOL = dict(rtol=1e-5, atol=1e-6)
WORKERS, BATCH = 2, 3
SHAPE = (32, 32, 3)
# (registry name, dataset, input shape); 10 classes each
MODELS = {"vgg11": ("vgg11", "synthetic_image", SHAPE),
          "wrn-10-2": ("wrn-10-2", "synthetic_image", SHAPE),
          "imagenet-resnet18": ("resnet18", "imagenet", (64, 64, 3))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its convolutions gain nothing
    from more when the file runs alone, and in a full run beside five other
    test processes more threads only contend for the cores.  Restored
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    name, dataset, shape = MODELS[request.param]
    jmodel = jax_select_model(name, dataset, num_classes=10)
    params, stats = jax_worker_variables(jmodel, shape, WORKERS, seed=3)
    pmodel = select_model(name, dataset, num_classes=10, num_workers=WORKERS,
                          input_shape=shape)
    load_into_port(pmodel, params, stats)
    return jmodel, pmodel, params, stats, shape


def _jax_forward(jmodel, params, stats, x):
    """Train-mode logits and batch statistics, and eval-mode logits, of
    every worker (one compiled program)."""
    def one(p, s, xb):
        variables = {"params": p, "batch_stats": s}
        train, mutated = jmodel.apply(variables, xb, train=True,
                                      mutable=["batch_stats"])
        return train, mutated["batch_stats"], jmodel.apply(
            variables, xb, train=False)

    train, new_stats, evals = jax.jit(jax.vmap(one))(params, stats,
                                                     jnp.asarray(x))
    return np.asarray(train), to_numpy(new_stats), np.asarray(evals)


def test_logits_and_bn_statistics_match_flax(pair):
    jmodel, pmodel, params, stats, shape = pair
    x, _ = images(WORKERS, BATCH, seed=4, shape=shape)
    ref_train, new_stats, ref_eval = _jax_forward(jmodel, params, stats, x)
    for train_mode, ref in ((False, ref_eval), (True, ref_train)):
        load_into_port(pmodel, params, stats)
        pmodel.train(train_mode)
        with torch.no_grad():
            out = pmodel(torch.from_numpy(x)).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
        buffers = {k: v.numpy() for k, v in pmodel.named_buffers()}
        # train mode moves the running statistics flax's way; eval mode
        # leaves them untouched
        want = stats_like_port(new_stats if train_mode else stats)
        assert set(buffers) == set(want)
        for name, value in want.items():
            np.testing.assert_allclose(buffers[name], value, **STAT_TOL,
                                       err_msg=name)


def test_gradients_match_flax_in_float64(pair):
    jmodel, pmodel, params, stats, shape = pair
    x, y = images(WORKERS, BATCH, seed=5, shape=shape)
    f64 = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, jnp.float64), tree)
    with jax.enable_x64(True):
        jmodel64 = jmodel.clone(dtype=jnp.float64)

        def loss(p, s, xb, yb):
            logits, _ = jmodel64.apply({"params": p, "batch_stats": s}, xb,
                                       train=True, mutable=["batch_stats"])
            return jax_cross_entropy(logits, yb)

        grads = jax.jit(jax.vmap(jax.grad(loss)))(
            f64(params), f64(stats), jnp.asarray(x, jnp.float64),
            jnp.asarray(y))
        ref = flatten_like_port(to_numpy(grads))
    load_into_port(pmodel, params, stats)
    model = pmodel.double().train()
    try:
        model.zero_grad(set_to_none=True)
        cross_entropy_loss(model(torch.from_numpy(x).double()),
                           torch.from_numpy(y)).sum().backward()
        got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    finally:
        pmodel.float()
    assert set(got) == set(ref)
    scale = max(np.abs(g).max() for g in ref.values())
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("name,dataset,shape", [
    ("vgg16", "cifar10", (32, 32, 3)), ("wrn", "cifar100", (32, 32, 3)),
    ("resnet50", "imagenet", (224, 224, 3))])
def test_full_width_parameter_count_and_tree_order(name, dataset, shape):
    """Leaf k of the port is leaf k of the JAX tree, with its size, at the
    reference's widths (``jax.eval_shape``: nothing is computed)."""
    jmodel = jax_select_model(name, dataset)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1,) + shape), train=False))
    leaves = jax.tree_util.tree_leaves(shapes["params"])
    with torch.device("meta"):
        pmodel = select_model(name, dataset, num_workers=1)
    flat = WorkerFlattener(dict(pmodel.named_parameters()))
    assert flat.sizes == [int(np.prod(a.shape)) for a in leaves]
    assert flat.dim == {"vgg16": 14_728_266, "wrn": 36_546_980,
                        "resnet50": 25_583_592}[name]


def test_registry_reference_policy():
    """``tests/test_models.py:104`` and :132, against the JAX registry."""
    cases = [("res", "cifar10"), ("res", "cifar100"), ("res", "imagenet"),
             ("VGG", "cifar10"), ("vgg", "cifar10"), ("vgg19", "cifar10"),
             ("wrn", "cifar100"), ("wrn-16-4", "cifar10"),
             ("resnet20", "cifar10"), ("resnet50", "imagenet"),
             ("resnet18", "imagenet"), ("mlp", "emnist")]
    for name, dataset in cases:
        want = jax_select_model(name, dataset)
        with torch.device("meta"):
            got = select_model(name, dataset)
        assert type(got).__name__ == type(want).__name__, name
        head = got.fc3 if name == "mlp" else got.head  # weight [N, out, in]
        assert head.weight.shape[1] == want.num_classes, name
        for attr in ("depth", "widen_factor"):
            if hasattr(want, attr):
                assert getattr(got, attr) == getattr(want, attr), (name, attr)
    with torch.device("meta"):
        assert select_model("res", "cifar100").head.weight.shape[1] == 100
        assert isinstance(select_model("res", "imagenet"), ResNetImageNet)
    assert resnet_imagenet_config(18) == ("basic", (2, 2, 2, 2))
    assert resnet_imagenet_config(50) == ("bottleneck", (3, 4, 6, 3))
    with pytest.raises(ValueError):
        resnet_imagenet_config(20)  # the 6n+2 family is CIFAR-only
    with pytest.raises(ValueError):
        vgg_config(12)
    with pytest.raises(KeyError):
        select_model("transformer")


# ------------------------------------------------------------------ remat

def _one_step(name, remat, grad_chunk=None, workers=WORKERS, seed=6):
    """One SGD step of ``name`` (no gossip): the parameters, their
    gradients and the batch statistics after it."""
    model = select_model(name, "synthetic_image", num_workers=workers,
                         remat=remat)
    opt = make_optimizer(make_lr_schedule(0.1, 4, warmup=False))
    state, flattener = init_train_state(model, workers, opt, make_none(),
                                        seed=seed, device="cpu")
    step = make_train_step(opt, make_none(), flattener, np.zeros((2, 1)),
                           grad_chunk=grad_chunk)
    x, y = images(workers, BATCH, seed=seed)
    step(state, torch.from_numpy(x), torch.from_numpy(y).long())
    out = {f"p.{k}": p.detach().clone() for k, p in model.named_parameters()}
    out.update({f"g.{k}": p.grad.clone()
                for k, p in model.named_parameters()})
    out.update({f"b.{k}": b.clone() for k, b in model.named_buffers()})
    return out


@pytest.mark.parametrize("name", ["resnet8", "vgg11", "wrn-10-2"])
def test_remat_keeps_parameters_gradients_and_statistics(name):
    """``tests/test_models.py:164``'s law: remat on or off, the parameter
    names, and after one step the parameters, gradients and batch
    statistics, are the same (the recompute moves no running statistic)."""
    off, on = _one_step(name, False), _one_step(name, True)
    assert list(on) == list(off)
    for key in off:
        assert torch.equal(on[key], off[key]), key


def test_remat_off_the_grad_path_is_the_plain_forward():
    model = select_model("resnet8", "synthetic_image", num_workers=2,
                         remat=True).eval()
    init_workers(model, seed=0)
    plain = select_model("resnet8", "synthetic_image", num_workers=2)
    plain.load_state_dict(model.state_dict())
    x = torch.from_numpy(images(2, 2, seed=1)[0])
    with torch.no_grad():
        assert torch.equal(model(x), plain.eval()(x))


@pytest.mark.parametrize("name,chunk", [("resnet8", 1), ("resnet8", 2),
                                        ("wrn-10-2", 2)])
def test_grad_chunk_equals_all_workers_at_once(name, chunk):
    _assert_close(_one_step(name, False, grad_chunk=chunk, workers=4),
                  _one_step(name, False, workers=4))


def _assert_close(got, want):
    scale = {}  # the largest magnitude of each kind: p., g. or b.
    for key, value in want.items():
        kind = key[:2]
        scale[kind] = max(scale.get(kind, 0.0), float(value.abs().max()))
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-5 * scale[key[:2]],
                                   err_msg=key)


def test_grad_chunk_with_remat_and_validation():
    _assert_close(_one_step("resnet8", True, grad_chunk=2, workers=4),
                  _one_step("resnet8", False, workers=4))
    for bad in (0, 3, 5):
        with pytest.raises(ValueError, match="grad_chunk"):
            _one_step("resnet8", False, grad_chunk=bad, workers=4)
    with pytest.raises(ValueError, match="grad_chunk"):
        TrainConfig(num_workers=8, grad_chunk=3)
    with pytest.raises(ValueError, match="grad_chunk"):
        TrainConfig(num_workers=8, grad_chunk=0)


def test_train_remat_and_grad_chunk_match_the_plain_run():
    """``tests/test_train.py:158``: one epoch of ResNet-8 under each knob
    against the plain run (the same bars as there)."""
    cfg = TrainConfig(
        name="remat-eq", model="resnet8", dataset="synthetic_image",
        dataset_kwargs={"num_train": 32, "num_test": 16, "separation": 40.0},
        num_workers=4, graphid=None, topology="ring", batch_size=4, epochs=1,
        lr=0.05, warmup=False, matcha=False, fixed_mode="all", seed=0,
        measure_comm_split=False, gossip_backend="perm")
    ref = train(cfg, device="cpu").history[-1]
    for knob in ({"remat": True}, {"grad_chunk": 2},
                 {"remat": True, "grad_chunk": 2}):
        got = train(dataclasses.replace(cfg, **knob),
                    device="cpu").history[-1]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5), knob
        assert got["test_acc_mean"] == pytest.approx(
            ref["test_acc_mean"], abs=1e-6), knob
        assert got["disagreement"] == pytest.approx(
            ref["disagreement"], rel=1e-4, abs=1e-8), knob


def test_wrn_dropout_draws_from_its_generator_and_remat_reuses_the_mask():
    """Dropout (off in the reference's runs) stays an option: its masks
    come from the model's own generator, so a seed fixes them, and a
    remat'd block draws its mask once, before its body, so the recompute
    applies the same one: remat on and off give bitwise the same step."""
    x = torch.from_numpy(images(2, 3, seed=7)[0])

    def grads(remat):
        model = select_model("wrn-10-2", "synthetic_image", num_workers=2,
                             remat=remat)
        init_workers(model, seed=0)
        model.dropout_rate = 0.3
        model.dropout_generator = torch.Generator().manual_seed(11)
        model.train()
        out = model(x)
        out.square().sum().backward()
        return out.detach(), {k: p.grad for k, p in model.named_parameters()}

    out_off, g_off = grads(False)
    out_on, g_on = grads(True)
    assert torch.equal(out_on, out_off)
    for k in g_off:
        assert torch.equal(g_on[k], g_off[k]), k
    # a dropout run differs from the same weights without dropout
    plain = select_model("wrn-10-2", "synthetic_image", num_workers=2)
    init_workers(plain, seed=0)
    assert not torch.equal(plain.train()(x).detach(), out_off)
