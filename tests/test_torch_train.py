"""The port's training slice against the JAX package's, and its entry rules.

Slice parity: ResNet-8 on 8 workers, zoo graph 0, MATCHA budget 0.5, batch
4, once with the perm backend and once with the fused backend (whose
training step is the dense product ``W_t @ x``).  The port's
``make_train_step`` and the JAX package's run three steps from the same
initial weights (the JAX package's synced init, carried by ``convert.py``)
on the same batches.

Both sides compute the forward and backward in float64.  In float32 the
comparison is a coin toss: one step of this network evaluates about 2.6e5
ReLU pre-activations, and a float32 rounding difference (1e-7 relative)
flips the ReLU mask of any that lies that close to 0, which changes the
gradient of every earlier layer at the percent level.  At this seed the
JAX package's own float32 gradient (XLA on the CPU) differs from its
float64 gradient by 1.4e-3 in ``stage1_block0.conv1`` for exactly that
reason, while the port's float32 gradient agrees with float64 to 2e-7.
The gossip runs in float32 on both sides, as it always does (the
flatteners cast the parameter stack to float32 and back).  Parameters,
batch-norm statistics, momentum, loss and disagreement agree to 1e-6
absolute: the float32 gossip of values that differ in the last bits of
float64 may round one float32 ulp apart (6e-8 relative), and three steps
at a learning rate near 0.1 carry that into the parameters.  The same
1e-6 holds for the fused backend: its dense step sums each mixing matrix
and each 8-term product in another order than XLA, again about one
float32 ulp.  Each backend's JAX run is shared by the file through a
module-scoped fixture (most of its cost is compilation).
"""

import ast
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    flatten_like_port,
    load_into_port,
    stats_like_port,
    to_numpy,
)
from matcha_tpu import data as jdata
from matcha_tpu import parallel as jax_parallel
from matcha_tpu.communicator import make_decen as jax_make_decen
from matcha_tpu.models import select_model as jax_select_model
from matcha_tpu.ops import WorkerFlattener as JaxWorkerFlattener
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train.loop import build_schedule as jax_build_schedule
from matcha_tpu.train.lr import make_lr_schedule as jax_make_lr_schedule
from matcha_tpu.train.state import init_train_state as jax_init_train_state
from matcha_tpu.train.state import make_optimizer as jax_make_optimizer
from matcha_tpu.train.state import make_train_step as jax_make_train_step
from matcha_tpu_torch.communicator import make_decen
from matcha_tpu_torch.models import select_model
from matcha_tpu_torch.ops import WorkerFlattener
from matcha_tpu_torch.parallel import LAUNCHES
from matcha_tpu_torch.train import (
    TrainConfig,
    TrainState,
    build_schedule,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    train,
)

REPO = Path(__file__).resolve().parent.parent
N, B, STEPS, SEED = 8, 4, 3, 9001
TOL = dict(rtol=0, atol=1e-6)
CONFIG = dict(model="resnet8", dataset="synthetic_image", num_workers=N,
              graphid=0, matcha=True, budget=0.5, batch_size=B, seed=SEED)
# the JAX loop's per-epoch keys besides the step metrics
# (matcha_tpu/train/loop.py, ``history.append``)
EPOCH_KEYS = {"epoch", "test_acc_mean", "test_loss_mean", "epoch_time",
              "comm_time", "comm_encode_time", "comm_exchange_time"}


def _batches():
    ds = jdata.synthetic_images(num_train=256, num_test=32, seed=SEED)
    parts = jdata.partition_indices(256, N, seed=SEED)
    loader = jdata.WorkerBatches(ds.x_train, ds.y_train, parts, B, seed=SEED)
    return [b for _, b in zip(range(STEPS), loader.epoch(0))], \
        loader.batches_per_epoch


def _momentum(opt_state):
    """The trace of optax's nesterov sgd inside the chain's state."""
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda s: hasattr(s, "trace")):
        if hasattr(leaf, "trace"):
            return to_numpy(leaf.trace)
    raise AssertionError("no momentum trace in the optax state")


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module", params=["perm", "fused"])
def backend(request):
    """The slice's gossip backend: the perm kernel, or the fused backend
    (whose training step is the dense product)."""
    return request.param


@pytest.fixture(scope="module")
def jax_run(backend):
    batches, bpe = _batches()
    # the host-evaluated learning rates, outside float64 mode (float32)
    lrs = [float(jax_make_lr_schedule(0.8, bpe)(t)) for t in range(STEPS)]
    # The double-buffered Pallas kernel does not trace in float64 mode (its
    # window index mixes int32 and int64); the streamed one (dbuf=False) is
    # bitwise the same chain (tests/test_perm_backend.py), so the JAX
    # communicator is built on that one.
    streamed = functools.partial(jax_parallel.perm_gossip_run, dbuf=False)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_parallel, "perm_gossip_run", streamed)
        sched = jax_build_schedule(JaxTrainConfig(**CONFIG), STEPS + 1)
        comm = jax_make_decen(sched, backend=backend)  # interpret on the CPU
        lr = jax_make_lr_schedule(0.8, bpe)
        opt = jax_make_optimizer(lr, 0.9, 5e-4, True)
        model = jax_select_model("resnet8", "synthetic_image",
                                 dtype=jnp.float64)
        state, _ = jax_init_train_state(model, (32, 32, 3), N, opt, comm,
                                        seed=0)
        params, stats = _f64(state.params), _f64(state.batch_stats)
        state = state.replace(params=params, batch_stats=stats,
                              opt_state=opt.init(params))
        init = (to_numpy(params), to_numpy(stats))
        step = jax_make_train_step(model, opt, comm,
                                   JaxWorkerFlattener(params), sched.flags,
                                   lr_schedule=lr)
        metrics = []
        for xb, yb in batches:
            state, m = step(state, jnp.asarray(xb, jnp.float64),
                            jnp.asarray(yb))
            metrics.append({k: float(v) for k, v in m.items()})
        for m, want in zip(metrics, lrs):
            m["lr"] = want
        return {"batches": batches, "bpe": bpe, "init": init,
                "params": to_numpy(state.params),
                "stats": to_numpy(state.batch_stats),
                "momentum": _momentum(state.opt_state), "metrics": metrics}


@pytest.fixture(scope="module")
def port_run(jax_run, backend):
    sched = build_schedule(TrainConfig(**CONFIG), STEPS + 1)
    comm = make_decen(sched, backend, device="cpu")
    lr = make_lr_schedule(0.8, jax_run["bpe"])
    opt = make_optimizer(lr, 0.9, 5e-4, True)
    model = select_model("resnet8", "synthetic_image", num_workers=N)
    load_into_port(model, *jax_run["init"]).to(torch.float64)
    state = TrainState(model=model, optimizer=opt.init(model.parameters()),
                       comm_carry=(), step=0)
    flattener = WorkerFlattener(state.params)
    step = make_train_step(opt, comm, flattener, sched.flags, lr)
    metrics = []
    for xb, yb in jax_run["batches"]:
        state, m = step(state, torch.from_numpy(xb).to(torch.float64),
                        torch.from_numpy(yb).long())
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def test_slice_params_match_jax_after_three_steps(jax_run, port_run):
    state, _ = port_run
    want = flatten_like_port(jax_run["params"])
    got = {k: v.detach().numpy() for k, v in state.params.items()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **TOL,
                                   err_msg=name)


def test_slice_bn_statistics_match_jax(jax_run, port_run):
    state, _ = port_run
    want = stats_like_port(jax_run["stats"])
    got = {k: v.numpy() for k, v in state.batch_stats.items()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **TOL,
                                   err_msg=name)


def test_slice_momentum_matches_jax(jax_run, port_run):
    state, _ = port_run
    want = flatten_like_port(jax_run["momentum"])
    for name, p in state.model.named_parameters():
        buf = state.optimizer.state[p]["momentum_buffer"]
        np.testing.assert_allclose(buf.numpy(), want[name], **TOL,
                                   err_msg=name)


def test_slice_metrics_match_jax(jax_run, port_run):
    _, metrics = port_run
    assert len(metrics) == len(jax_run["metrics"]) == STEPS
    for got, want in zip(metrics, jax_run["metrics"]):
        assert set(got) == set(want)
        for key in ("loss", "disagreement", "accuracy"):
            assert abs(got[key] - want[key]) <= TOL["atol"], key
        # host-evaluated in float32 like jnp: exactly the JAX values
        assert got["lr"] == want["lr"]
        assert got["active_matchings"] == want["active_matchings"]


def test_train_on_cpu_returns_finite_history_with_jax_keys(jax_run, backend):
    before = dict(LAUNCHES)
    cfg = TrainConfig(**CONFIG, epochs=1, gossip_backend=backend,
                      dataset_kwargs={"num_train": 128, "num_test": 32})
    result = train(cfg, device="cpu")
    assert LAUNCHES == before  # the CPU path runs the plain version
    assert len(result.history) == 1
    hist = result.history[0]
    assert set(hist) == EPOCH_KEYS | set(jax_run["metrics"][0])
    assert all(np.isfinite(v) for v in hist.values())
    assert result.state.step == 128 // N // B


def test_train_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(TrainConfig(**CONFIG, epochs=1))
    for name in ("perm", "dense", "fused"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_decen(build_schedule(TrainConfig(**CONFIG), 2), name)


@pytest.mark.parametrize("cli_backend", ["perm", "gather", "dense", "fused",
                                         "skip"])
def test_cli_parses_the_slice_flags(cli_backend):
    sys.path.insert(0, str(REPO))
    try:
        import train_torch
    finally:
        sys.path.remove(str(REPO))
    cfg, device = train_torch.parse_args(
        ["--model", "resnet20", "--dataset", "synthetic_image",
         "--numworkers", "16", "--graphid", "4", "--budget", "0.5",
         "--no-matcha", "--bs", "32", "--lr", "0.1", "--epoch", "2",
         "--backend", cli_backend, "--wire-dtype", "bf16", "--seed", "7"])
    assert device == "cuda"
    assert (cfg.model, cfg.num_workers, cfg.graphid, cfg.matcha,
            cfg.batch_size, cfg.lr, cfg.epochs, cfg.gossip_backend,
            cfg.wire_dtype, cfg.seed) == ("resnet20", 16, 4, False, 32, 0.1,
                                          2, cli_backend, "bf16", 7)
    with pytest.raises(SystemExit):
        train_torch.parse_args(["--backend", "shard_map"])


def test_cli_parses_the_epoch_end_flags():
    sys.path.insert(0, str(REPO))
    try:
        import train_torch
    finally:
        sys.path.remove(str(REPO))
    cfg, device = train_torch.parse_args(
        ["--model", "mlp", "--dataset", "digits", "--graphid", "5",
         "--name", "ring", "--save", "--savePath", "out",
         "--checkpoint-every", "2", "--resume", "out/ring_ckpt",
         "--communicator", "centralized", "--device", "cpu"])
    assert (cfg.dataset, cfg.name, cfg.save, cfg.savePath,
            cfg.checkpoint_every, cfg.resume, cfg.communicator, device) == (
        "digits", "ring", True, "out", 2, "out/ring_ckpt", "centralized",
        "cpu")
    cfg, _ = train_torch.parse_args([])
    assert (cfg.save, cfg.checkpoint_every, cfg.resume,
            cfg.communicator) == (False, 0, None, "decen")
    for bad in (["--communicator", "gossip"], ["--dataset", "cifar10"],
                ["--compress", "--communicator", "centralized"]):
        with pytest.raises(SystemExit):
            train_torch.parse_args(bad)


@pytest.mark.parametrize("field,value", [
    ("devices", 2), ("scan_chunk", 4),
])
def test_config_refuses_unported_features(field, value):
    from matcha_tpu_torch.train.config import _UNPORTED

    assert set(_UNPORTED) == {"scan_chunk", "devices"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig(**{field: value})


def test_config_takes_the_profiler_window():
    cfg = TrainConfig(trace_dir="t", trace_epoch=0)
    assert (cfg.trace_dir, cfg.trace_epoch) == ("t", 0)
    for config in (TrainConfig, JaxTrainConfig):
        with pytest.raises(ValueError, match="trace_epoch"):
            config(trace_epoch=-1)


@pytest.mark.parametrize("unported", ["auto", "shard_map"])
def test_unported_backends_raise_naming_the_roadmap(unported):
    """``shard_map`` raises; ``auto`` resolves to it only on a mesh of more
    than one device, and what it resolves to there raises the same way."""
    from types import SimpleNamespace

    from matcha_tpu_torch.communicator.decen import resolve_gossip_backend

    sched = build_schedule(TrainConfig(**CONFIG), 2)
    backend = resolve_gossip_backend(
        sched, SimpleNamespace(size=2), requested=unported)["chosen"]
    assert backend == "shard_map"
    with pytest.raises(ValueError, match="ROADMAP.md"):
        make_decen(sched, backend, device="cpu")


def test_config_validates_like_jax():
    for bad in (dict(num_workers=1), dict(budget=1.5),
                dict(wire_dtype="fp8"), dict(overlap="2step")):
        with pytest.raises(ValueError):
            JaxTrainConfig(**bad)
        with pytest.raises(ValueError):
            TrainConfig(**bad)


# ------------------------------------------------------- no JAX in the port

BANNED = ("jax", "flax", "optax", "matcha_tpu", "ml_dtypes")


def _port_files():
    return sorted((REPO / "matcha_tpu_torch").rglob("*.py")) + [
        REPO / "train_torch.py", REPO / "plan_torch.py",
        REPO / "obs_torch.py", REPO / "serve_torch.py",
        REPO / "chaos_torch.py", REPO / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    bad = []
    for path in _port_files():
        for module in _imported_modules(path):
            # the module name, exactly: matcha_tpu_torch is the port itself
            if module.split(".")[0] in BANNED:
                bad.append(f"{path.relative_to(REPO)}: {module}")
    assert not bad, bad


# packages the card's host lacks: the port imports none of them at import
# time (digits and photo_patches import sklearn and PIL when built)
ABSENT_ON_CARD_HOST = ("sklearn", "PIL", "matplotlib", "pygame", "orbax")


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (REPO / "matcha_tpu_torch").rglob("*.py"))
    assert {"matcha_tpu_torch.probes.split_probe",
            "matcha_tpu_torch.plan.cost", "matcha_tpu_torch.analysis.planlint",
            "matcha_tpu_torch.elastic.policy", "matcha_tpu_torch.serve",
            "matcha_tpu_torch.serve.trainer", "matcha_tpu_torch.chaos",
            "matcha_tpu_torch.chaos.campaign"} <= set(modules)
    code = f"""
import importlib, importlib.abc, sys
BANNED = {BANNED + ABSENT_ON_CARD_HOST!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for name in {modules!r} + ["train_torch", "plan_torch", "obs_torch",
                           "serve_torch", "chaos_torch", "chip_smoke"]:
    importlib.import_module(name)
leaked = [m for m in sys.modules if m.split(".")[0] in BANNED]
assert not leaked, leaked
from matcha_tpu_torch.data import photo_patches, uci_digits
for build, package in ((uci_digits, "sklearn"), (photo_patches, "PIL")):
    try:
        build()
    except ImportError as e:
        assert package in str(e), e
    else:
        raise AssertionError(build.__name__ + " built without " + package)
print("ok", len({modules!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
