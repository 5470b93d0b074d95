"""The run controller of the port (``matcha_tpu_torch.serve`` and
``serve_torch.py``) against the JAX package's (``matcha_tpu.serve``), on
the CPU.

The recipe is the JAX serve tests' (``tests/test_serve.py``): the MLP on
``synthetic`` data, ring-8 (zoo graph 5), MATCHA at budget 0.5, 4 steps
an epoch, a checkpoint every epoch.  Where both ``train()``s run, the port
starts from the JAX run's initial parameters (its per-worker init and
sync, carried over by ``_torch_parity.load_into_port``; the port's own
sync off).

Tolerances, and why:

* Control documents, constants, the promote/rollback sequence, the files
  ``prune_serving`` removes, manifests and their verdicts, journal
  decisions of the controller: exact (host code on both sides).
* A budget swap's journaled detail (α, ρ, α scale, the row scales):
  1e-12 relative, since both sides run the same float64 numpy solver.
* Per-epoch training loss and disagreement of the swapped runs: 1e-4
  relative, the bar of ``tests/test_torch_acceptance.py`` for the same
  reason: XLA and PyTorch sum the MLP's products in other orders, so the
  runs part by f32 rounding from the first step, and 16 SGD steps carry
  it forward.
* The telemetry's matchings and wire bytes per epoch: exact (sums of 0/1
  flag rows and byte counts).
* ``snapshot_consensus``: four f32 ulps of each array's largest magnitude
  (a mean over 4 workers summed in another order).
* Identity knobs: bitwise, on the port alone (a supervised run against an
  unsupervised one).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import obs_torch
import serve_torch
from _torch_parity import load_into_port, to_numpy
from matcha_tpu import serve as jserve
from matcha_tpu.obs import fleet_verdict as jax_fleet_verdict
from matcha_tpu.ops.flatten import make_flattener as jax_make_flattener
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu_torch import serve
from matcha_tpu_torch.convert import params_from_jax
from matcha_tpu_torch.models import select_model
from matcha_tpu_torch.obs import fleet_verdict, read_journal, validate_event
from matcha_tpu_torch.obs.health import heartbeat_path
from matcha_tpu_torch.ops import WorkerFlattener
from matcha_tpu_torch.train import TrainConfig, latest_step, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWAP_REL = 1e-12
RUN_REL = 1e-4
BASE = dict(name="serve", model="mlp", dataset="synthetic",
            dataset_kwargs={"num_train": 256, "num_test": 32},
            num_workers=8, graphid=5, batch_size=8, epochs=3, lr=0.05,
            warmup=False, matcha=True, budget=0.5, seed=3, save=True,
            eval_every=0, checkpoint_every=1, measure_comm_split=False)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _journal(folder):
    return read_journal(os.path.join(folder, "events.jsonl"))


def of_kind(events, kind):
    return [e for e in events if e["kind"] == kind]


# ------------------------------------------------------ control documents

DOCUMENTS = [
    {"version": 1},
    {"version": 3, "budget": 0.25, "local_steps": 2, "staleness": 2,
     "drift_tolerance": 0.5, "drift_patience": 4,
     "membership_hysteresis": 1, "membership_bootstrap": "mean"},
    {"version": 2, "stop": True},
    {"version": 0, "budget": 1.5, "stop": "yes", "mystery": 1,
     "local_steps": 0, "membership_bootstrap": "maybe"},
    {"version": True},
    {"version": 1, "local_steps": 2.0},
    {"budget": 0.5},
    [1, 2],
    {"version": 1, "mystery": 3},
    {"version": 1, "budget": True},
    {"version": "1"},
    {"version": 2, "budget": 0},
    {"version": 4, "staleness": 1, "membership_bootstrap": "restore"},
    {"version": 5, "drift_tolerance": 0, "drift_patience": 1},
    {"version": 6, "membership_hysteresis": -1},
    {"version": 7, "stop": False, "budget": 1},
]


@pytest.mark.parametrize("doc", DOCUMENTS, ids=range(len(DOCUMENTS)))
def test_control_document_verdicts_equal_jax(tmp_path, doc):
    """``validate_control``, ``load_control`` and ``write_control`` give
    the JAX package's verdicts, problem for problem."""
    assert serve.validate_control(doc) == jserve.validate_control(doc)
    path = str(tmp_path / "raw.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    assert serve.load_control(path) == jserve.load_control(path)
    verdicts = []
    for package in (serve, jserve):
        out = str(tmp_path / package.__name__ / "control.json")
        try:
            package.write_control(out, doc)
            verdicts.append(("written", package.load_control(out)))
        except ValueError as e:
            verdicts.append(("refused", str(e)))
    assert verdicts[0] == verdicts[1]


def test_control_constants_and_unreadable_documents(tmp_path):
    assert (serve.RESTART_EXIT, serve.CONTROL_BASENAME) == \
        (jserve.RESTART_EXIT, jserve.CONTROL_BASENAME) == (43, "control.json")
    for mine, theirs in ((serve.VALUE_FIELDS, jserve.VALUE_FIELDS),
                         (serve.RESTART_FIELDS, jserve.RESTART_FIELDS)):
        assert list(mine) == list(theirs)
        for key in mine:
            assert mine[key][:2] == theirs[key][:2]
    assert (serve.MANIFEST_FORMAT, serve.MANIFEST_BASENAME) == \
        (jserve.MANIFEST_FORMAT, jserve.MANIFEST_BASENAME)
    assert serve.load_control(str(tmp_path / "none.json")) == (None, [])
    bad = tmp_path / "control.json"
    bad.write_text("{not json")
    assert serve.load_control(str(bad)) == jserve.load_control(str(bad))
    # a refused write leaves the previous document and no temp file
    serve.write_control(str(bad), {"version": 1, "budget": 0.25})
    with pytest.raises(ValueError, match="budget"):
        serve.write_control(str(bad), {"version": 2, "budget": 7})
    assert serve.load_control(str(bad)) == ({"version": 1, "budget": 0.25},
                                            [])
    assert [f for f in os.listdir(tmp_path) if f.startswith(".control")] \
        == []


def test_control_knobs_identity():
    knobs = serve.ControlKnobs.fresh(5)
    assert knobs.row_scale.tolist() == [1.0] * 5
    assert knobs.row_scale.dtype == torch.float32
    assert (knobs.alpha_scale, knobs.local_every) == (1.0, 1)
    # local_every clamps at 1; alpha_scale is the f32 the JAX knob holds
    knobs = serve.control_arrays([1.0], 0.1, 0)
    assert knobs.local_every == 1
    assert knobs.alpha_scale == float(np.float32(0.1))


# ------------------------------------------------------ train() under a hook

def _flat(result):
    return torch.cat([p.detach().reshape(8, -1)
                      for p in result.state.model.parameters()], dim=1)


def test_identity_knobs_are_bitwise_the_unsupervised_run(tmp_path):
    """A supervised run that gets no control document equals a plain
    ``train()`` bit for bit: the row scale and the α scale multiply by
    exactly 1.0 and the cadence is the config's."""
    cfg = TrainConfig(**dict(BASE, epochs=2), savePath=str(tmp_path))
    plain = train(dataclasses.replace(cfg, name="plain"), device="cpu")
    harness = serve.TrainerHarness({})
    sup = train(dataclasses.replace(cfg, name="sup"), device="cpu",
                boundary_hook=harness.on_boundary)
    assert torch.equal(_flat(plain), _flat(sup))
    rows = lambda r: [(h["loss"], h["disagreement"], h["accuracy"])
                      for h in r.history]
    assert rows(plain) == rows(sup)
    assert not harness.restart_requested
    assert isinstance(sup.state.control, serve.ControlKnobs)
    assert plain.state.control == ()


def _swap_hook(harness, control):
    """The hook that publishes a budget swap before epoch 1's boundary and
    a ``local_steps`` swap before epoch 2's, then runs ``harness``."""
    write = (serve.write_control if isinstance(harness, serve.TrainerHarness)
             else jserve.write_control)

    def hook(seam):
        if seam.epoch == 1:
            write(control, {"version": 1, "budget": 0.25})
        elif seam.epoch == 2:
            write(control, {"version": 2, "local_steps": 2})
        harness.on_boundary(seam)

    return hook


@pytest.fixture(scope="module")
def swap_runs(tmp_path_factory):
    """The port's and the JAX ``train(boundary_hook=...)`` through the two
    swaps, 4 epochs, from the JAX run's initial parameters."""
    root = tmp_path_factory.mktemp("swap")
    init = jax_train(JaxTrainConfig(**dict(BASE, epochs=0, save=False),
                                    telemetry=False, health=False)).state
    params, stats = to_numpy(init.params), to_numpy(init.batch_stats)
    cfg = dict(BASE, name="swap", epochs=4)
    jax_control = str(root / "jax" / "control.json")
    ref = jax_train(JaxTrainConfig(**cfg, savePath=str(root / "jax")),
                    boundary_hook=_swap_hook(
                        jserve.TrainerHarness({"control_path": jax_control}),
                        jax_control))
    control = str(root / "port" / "control.json")
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr("matcha_tpu_torch.train.state.init_workers",
                      lambda model, seed: load_into_port(model, params,
                                                         stats))
        port = train(TrainConfig(**cfg, savePath=str(root / "port"),
                                 sync_init=False), device="cpu",
                     boundary_hook=_swap_hook(
                         serve.TrainerHarness({"control_path": control}),
                         control))
    return port, ref


def test_swap_detail_equals_jax(swap_runs):
    port, ref = swap_runs
    got = of_kind(_journal(port.recorder.folder), "control")
    want = of_kind(_journal(ref.recorder.folder), "control")
    assert all(validate_event(e) == [] for e in got)
    strip = lambda e: (e["action"], e["applied"], e["epoch"], e["version"],
                       e["reason"], sorted(e["fields"]))
    assert [strip(e) for e in got] == [strip(e) for e in want] == [
        ("apply", True, 1, 1, "value-scope fields ['budget']", ["budget"]),
        ("apply", True, 2, 2, "value-scope fields ['local_steps']",
         ["local_steps"])]
    mine, theirs = got[0]["fields"]["budget"], want[0]["fields"]["budget"]
    assert mine["budget"] == theirs["budget"] == 0.25
    for key in ("alpha", "rho", "alpha_scale", "unreachable"):
        assert _rel(mine[key], theirs[key]) <= SWAP_REL, key
    assert len(mine["row_scale"]) == len(theirs["row_scale"])
    for a, b in zip(mine["row_scale"], theirs["row_scale"]):
        assert _rel(a, b) <= SWAP_REL
    assert got[1]["fields"]["local_steps"] == 2
    # each event re-bases the journal's prediction, as JAX's does
    for g, w in zip(got, want):
        assert set(g["predicted"]) == set(w["predicted"])
        for key, value in w["predicted"].items():
            assert _rel(g["predicted"][key], value) <= SWAP_REL, key


def test_swapped_runs_agree_with_jax(swap_runs):
    port, ref = swap_runs
    assert len(port.history) == len(ref.history) == 4
    for mine, theirs in zip(port.history, ref.history):
        for key in ("loss", "disagreement"):
            assert _rel(mine[key], theirs[key]) <= RUN_REL, (mine["epoch"],
                                                             key)
    got = of_kind(_journal(port.recorder.folder), "telemetry")
    want = of_kind(_journal(ref.recorder.folder), "telemetry")
    assert [(e["epoch"], e["steps"], e["matchings_mean"], e["wire_bytes"])
            for e in got] == \
        [(e["epoch"], e["steps"], e["matchings_mean"], e["wire_bytes"])
         for e in want]
    # the knobs the last epoch ran with: the journaled swap's
    (swap,) = [e["fields"]["budget"] for e in of_kind(
        _journal(port.recorder.folder), "control") if "budget" in e["fields"]]
    knobs = port.state.control
    assert knobs.local_every == 2
    assert knobs.alpha_scale == float(np.float32(swap["alpha_scale"]))
    assert knobs.row_scale.tolist() == [float(np.float32(v))
                                        for v in swap["row_scale"]]


def test_stop_and_invalid_documents(tmp_path):
    """A document that is invalid against the running config is rejected
    whole (the JAX decision); a stop document checkpoints the completed
    epoch and drains."""
    control = str(tmp_path / "control.json")
    with open(control, "w") as f:  # staleness 2 needs overlap='1step'
        json.dump({"version": 1, "budget": 0.25, "staleness": 2}, f)
    harness = serve.TrainerHarness({"control_path": control})
    cfg = TrainConfig(**dict(BASE, name="rej", epochs=2),
                      savePath=str(tmp_path))
    result = train(cfg, device="cpu", boundary_hook=harness.on_boundary)
    assert len(result.history) == 2 and not harness.restart_requested
    controls = of_kind(_journal(result.recorder.folder), "control")
    assert [(e["action"], e["applied"]) for e in controls] == \
        [("reject", False)]
    assert "running config" in controls[0]["reason"]

    stop = str(tmp_path / "stop.json")
    harness = serve.TrainerHarness({"control_path": stop})

    def hook(seam):
        if seam.epoch == 1:
            serve.write_control(stop, {"version": 1, "stop": True})
        harness.on_boundary(seam)

    cfg = TrainConfig(**dict(BASE, name="halt", epochs=5,
                             checkpoint_every=0), savePath=str(tmp_path))
    result = train(cfg, device="cpu", boundary_hook=hook)
    assert len(result.history) == 1
    events = _journal(result.recorder.folder)
    assert [(e["action"], e["applied"])
            for e in of_kind(events, "control")] == [("stop", True)]
    assert [e["epoch"] for e in of_kind(events, "checkpoint")] == [0]
    assert latest_step(str(tmp_path / "halt_ckpt")) == 0


# ------------------------------------------------------------- promotion

def _candidate(package, serving_dir, epoch, acc):
    rng = np.random.default_rng(epoch)
    return package.write_candidate(
        serving_dir, epoch, step=epoch * 4,
        arrays={"params_flat": rng.normal(size=(8,)).astype(np.float32)},
        metrics={"test_acc": acc, "test_loss": 1.0 - acc},
        fingerprint="fp", journal_offset=epoch)


SERIES = ((1, 0.50, 0.0), (2, 0.60, 0.0), (3, 0.10, 0.0), (4, 0.55, 0.1),
          (5, 0.0, 0.0), (6, 0.56, 0.0))


def test_promotion_sequence_and_pruning_equal_jax(tmp_path):
    decisions, removed, files = {}, {}, {}
    for package in (serve, jserve):
        sdir = str(tmp_path / package.__name__)
        seq = []
        for epoch, acc, margin in SERIES:
            action, serving = package.decide_promotion(
                sdir, _candidate(package, sdir, epoch, acc), margin=margin)
            seq.append((action, serving["epoch"], serving["signature"]))
        decisions[package] = seq
        removed[package] = package.prune_serving(sdir, keep=1)
        files[package] = sorted(os.listdir(sdir))
    assert decisions[serve] == decisions[jserve]
    assert [a for a, _, _ in decisions[serve]] == [
        "promote", "promote", "rollback", "promote", "rollback", "promote"]
    assert removed[serve] == removed[jserve] != []
    assert files[serve] == files[jserve]


@pytest.mark.parametrize("writer,reader", [(serve, jserve), (jserve, serve),
                                           (serve, serve)])
def test_manifests_verify_across_packages(tmp_path, writer, reader):
    sdir = str(tmp_path / "serving")
    writer.decide_promotion(sdir, _candidate(writer, sdir, 1, 0.5))
    manifest = reader.verify_promoted(sdir)
    assert manifest == writer.current_manifest(sdir)
    assert manifest["format"] == "matcha-promotion-manifest-v1"


def _tamper_artifact(sdir):
    npz = os.path.join(sdir, "promoted-e00001.npz")
    blob = bytearray(open(npz, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(blob))


def _tamper_manifest(sdir):
    pointer = os.path.join(sdir, "MANIFEST.json")
    manifest = json.load(open(pointer))
    manifest["metrics"]["test_acc"] = 0.99
    json.dump(manifest, open(pointer, "w"))


def _tamper_missing(sdir):
    os.unlink(os.path.join(sdir, "promoted-e00001.npz"))


@pytest.mark.parametrize("tamper,needle", [
    (_tamper_artifact, "hash mismatch"), (_tamper_manifest, "signature"),
    (_tamper_missing, "missing")])
def test_tampering_is_refused_by_both(tmp_path, capsys, tamper, needle):
    sdir = str(tmp_path / "serving")
    with pytest.raises(serve.PromotionTampered, match="nothing promoted"):
        serve.verify_promoted(sdir)
    serve.decide_promotion(sdir, _candidate(serve, sdir, 1, 0.5))
    assert serve_torch.main(["verify", sdir]) == 0
    tamper(sdir)
    for package in (serve, jserve):
        with pytest.raises(package.PromotionTampered, match=needle):
            package.verify_promoted(sdir)
    assert serve_torch.main(["verify", sdir]) == 1
    capsys.readouterr()


def test_config_fingerprint():
    cfg = TrainConfig(**BASE)
    assert serve.config_fingerprint(cfg) == serve.config_fingerprint(
        dataclasses.asdict(cfg))
    assert serve.config_fingerprint(cfg) != serve.config_fingerprint(
        dataclasses.replace(cfg, budget=0.9))
    same = {"a": 1, "b": [1, 2]}
    assert serve.config_fingerprint(same) == jserve.config_fingerprint(same)


def _jax_trees(model, rng):
    """Random ``(params, batch_stats)`` in the JAX package's layout for a
    port ``model``: ``convert.py``'s mapping run backwards."""
    params, stats = {}, {}

    def put(tree, name, leaf, value):
        node = tree
        for part in name.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = value.astype(np.float32)

    for name, p in model.named_parameters():
        shape, leaf = tuple(p.shape), name.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) == 5:  # -> [N, kh, kw, in, out]
            value = rng.normal(scale=0.1, size=shape).transpose(0, 3, 4, 2, 1)
            leaf = "kernel"
        elif leaf == "weight" and len(shape) == 3:  # -> [N, in, out]
            value = rng.normal(scale=0.1, size=shape).transpose(0, 2, 1)
            leaf = "kernel"
        elif leaf == "weight":
            value, leaf = rng.uniform(0.5, 1.5, size=shape), "scale"
        else:
            value = rng.normal(scale=0.1, size=shape)
        put(params, name, leaf, value)
    for name, b in model.named_buffers():
        leaf = {"running_mean": "mean", "running_var": "var"}[
            name.rsplit(".", 1)[-1]]
        value = (rng.normal(size=tuple(b.shape)) if leaf == "mean"
                 else rng.uniform(0.5, 2.0, size=tuple(b.shape)))
        put(stats, name, leaf, value)
    return params, stats


def test_snapshot_consensus_matches_jax():
    """The port's consensus snapshot of a ResNet-8 (4 workers, random
    parameters and batch-norm statistics) against the JAX one on the same
    trees, the JAX flat mean mapped through ``convert.py`` into the port's
    layout."""
    n = 4
    model = select_model("resnet8", "cifar10", num_classes=10,
                         num_workers=n, input_shape=(8, 8, 3))
    params, stats = _jax_trees(model, np.random.default_rng(0))
    load_into_port(model, params, stats)
    jflat = jax_make_flattener(params)
    want = jserve.snapshot_consensus(
        SimpleNamespace(params=params, batch_stats=stats), jflat)

    named = dict(model.named_parameters())
    got = serve.snapshot_consensus(
        SimpleNamespace(params=named, batch_stats=dict(model.named_buffers())),
        WorkerFlattener(named))
    assert sorted(got) == sorted(want)
    tree = jflat.unflatten(want["params_flat"][None])
    mean_tree = params_from_jax(tree)[0]
    mapped = WorkerFlattener(mean_tree).flatten(mean_tree)[0]
    checks = [(got["params_flat"], mapped.numpy())]
    checks += [(got[k], want[k]) for k in want if k != "params_flat"]
    for mine, theirs in checks:
        assert mine.shape == theirs.shape and mine.dtype == np.float32
        bar = 4 * np.finfo(np.float32).eps * float(np.abs(theirs).max())
        assert float(np.abs(mine - theirs).max()) <= bar


def test_consensus_metrics_are_the_mean_models():
    """The mean model through ``functional_call`` equals a one-worker
    model loaded with the worker means, and leaves the live model as it
    was."""
    n = 4
    model = select_model("resnet8", "cifar10", num_classes=10,
                         num_workers=n, input_shape=(8, 8, 3))
    load_into_port(model, *_jax_trees(model, np.random.default_rng(1)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(40, 8, 8, 3)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 10, size=40))
    got = serve.consensus_metrics(SimpleNamespace(model=model), x, y,
                                  batch=16)
    one = select_model("resnet8", "cifar10", num_classes=10, num_workers=1,
                       input_shape=(8, 8, 3))
    one.load_state_dict({k: v.mean(dim=0, keepdim=True)
                         for k, v in model.state_dict().items()})
    one.eval()
    losses, accs, w = [], [], []
    from matcha_tpu_torch.utils import cross_entropy_loss, top_k_accuracy

    with torch.no_grad():
        for i in range(0, 40, 16):
            logits = one(x[i:i + 16].unsqueeze(0))
            losses.append(float(cross_entropy_loss(logits, y[None, i:i + 16])))
            accs.append(float(top_k_accuracy(logits, y[None, i:i + 16])))
            w.append(len(y[i:i + 16]))
    w = np.asarray(w, np.float64)
    assert got["test_loss"] == pytest.approx(
        float((np.asarray(losses) * w).sum() / w.sum()), rel=1e-6)
    assert got["test_acc"] == float((np.asarray(accs) * w).sum() / w.sum())
    assert model.training
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())


def test_promotion_through_train_rolls_back(tmp_path, monkeypatch):
    """A promotion eval that regresses keeps the serving pointer on the
    previous manifest and journals a ``rollback``."""
    import matcha_tpu_torch.serve.trainer as trainer_mod

    accs = iter([0.75, 0.10])

    def fake_metrics(state, x_test, y_test, batch=256):
        acc = next(accs)
        return {"test_acc": acc, "test_loss": 1.0 - acc}

    monkeypatch.setattr(trainer_mod, "consensus_metrics", fake_metrics)
    sdir = str(tmp_path / "serving")
    harness = serve.TrainerHarness({"serving_dir": sdir, "promote_every": 1})
    cfg = TrainConfig(**dict(BASE, name="roll"), savePath=str(tmp_path))
    result = train(cfg, device="cpu", boundary_hook=harness.on_boundary)
    promos = of_kind(_journal(result.recorder.folder), "promotion")
    assert [(e["action"], e["epoch"], e["serving_epoch"]) for e in promos] \
        == [("promote", 1, 1), ("rollback", 2, 1)]
    assert serve.verify_promoted(sdir)["epoch"] == 1
    assert jserve.verify_promoted(sdir)["epoch"] == 1
    with np.load(os.path.join(sdir, "promoted-e00002.npz")) as npz:
        assert npz["params_flat"].shape == (_flat(result).shape[1],)


# ------------------------------------------ fleet verdict and the endpoint

def _beat(health_dir, host, workers, dead=()):
    event = {
        "v": 3, "kind": "heartbeat", "t": time.time(), "host": host,
        "epoch": 0, "step": 4, "step_time": 0.1, "step_time_ewma": 0.1,
        "comp_time": 0.3, "comm_time": 0.1, "peak_bytes": None,
        "workers": {w: {"slot": i,
                        "participation": 0.0 if w in dead else 1.0,
                        "disagreement": 0.0}
                    for i, w in enumerate(workers)},
    }
    assert validate_event(event) == []
    os.makedirs(health_dir, exist_ok=True)
    with open(heartbeat_path(health_dir, host), "a") as f:
        f.write(json.dumps(event) + "\n")


class _StubRun:
    """The endpoint's duck-typed controller: file facts, no subprocess."""

    def __init__(self, run_dir, serving_dir):
        self.run_dir = run_dir
        self.serving_dir = serving_dir

    def status(self):
        return {"name": os.path.basename(self.run_dir), "lifetimes": 1}


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_is_the_fleet_verdict(tmp_path, capsys):
    """``/healthz``, ``fleet_verdict`` (both packages') and ``obs_torch.py
    watch --once`` give one verdict."""
    dirs = {"healthy": str(tmp_path / "healthy"),
            "flagged": str(tmp_path / "flagged"),
            "void": str(tmp_path / "void")}
    _beat(dirs["healthy"], "host0", ["w0", "w1", "w2", "w3"])
    _beat(dirs["flagged"], "host0", ["w0", "w1", "w2", "w3"], dead=("w1",))
    os.makedirs(dirs["void"])
    endpoint = serve.ServeEndpoint(
        {name: _StubRun(d, d) for name, d in dirs.items()}).start()
    try:
        for name, want in (("healthy", 0), ("flagged", 1), ("void", 2)):
            rc, status = fleet_verdict(dirs[name])
            assert rc == want == jax_fleet_verdict(dirs[name])[0]
            assert (status is None) == (want == 2)
            assert obs_torch.main(["watch", dirs[name], "--once"]) == want
            code, body = _get(endpoint.port, f"/healthz?run={name}")
            assert code == (200 if want == 0 else 503)
            assert body["verdict"] == want and body["ok"] == (want == 0)
            if want == 2:
                assert "no heartbeat evidence" in body["reason"]
            else:
                assert body["flagged"] == (want == 1)
        capsys.readouterr()
    finally:
        endpoint.stop()


def test_endpoint_routing_multi_tenant(tmp_path):
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    a_serving, b_serving = str(tmp_path / "a_s"), str(tmp_path / "b_s")
    _beat(a_dir, "host0", ["w0", "w1", "w2", "w3"])
    serve.decide_promotion(a_serving, _candidate(serve, a_serving, 1, 0.5))
    jserve.decide_promotion(b_serving, _candidate(jserve, b_serving, 1, 0.5))
    _tamper_manifest(b_serving)
    endpoint = serve.ServeEndpoint({"a": _StubRun(a_dir, a_serving),
                                    "b": _StubRun(b_dir, b_serving)}).start()
    try:
        port = endpoint.port
        code, body = _get(port, "/status?run=a")
        assert code == 200 and body["name"] == "a"
        assert body["fleet_verdict"] == 0 and not body["fleet"]["flagged"]
        code, body = _get(port, "/status")
        assert code == 404 and body["runs"] == ["a", "b"]
        assert _get(port, "/status?run=zzz")[0] == 404
        code, body = _get(port, "/promoted?run=a")
        assert code == 200 and body["verified"]
        assert body["manifest"]["epoch"] == 1
        code, body = _get(port, "/promoted?run=b")
        assert code == 503 and not body["verified"]
        assert "manifest" not in body and "signature" in body["error"]
        code, body = _get(port, "/nope?run=a")
        assert code == 404 and "/healthz" in body["routes"]
    finally:
        endpoint.stop()
    with pytest.raises(ValueError, match="at least one run"):
        serve.ServeEndpoint({})


# ------------------------------------------------- the supervisor (stubbed)

class _FakeProc:
    def __init__(self, rc):
        self._rc = rc

    def wait(self):
        return self._rc

    def poll(self):
        return self._rc


def _decisions(path):
    return [(e["kind"], e["action"], e["applied"], e["epoch"], e["reason"],
             e.get("fields")) for e in read_journal(path)]


def test_controller_budget_and_abort_equal_jax(tmp_path, monkeypatch):
    """Every crash charges the budget and journals; exhaustion aborts
    with the crash's code — the JAX controller's decisions, word for
    word."""
    journals = []
    for package in (serve, jserve):
        cfg = dict(name="crashy", model="mlp",
                   savePath=str(tmp_path / package.__name__))
        ctl = package.Controller(package.ServeConfig(
            config=cfg, restart_budget=2, backoff=0.01, backoff_max=0.02,
            jitter_seed=0))
        monkeypatch.setattr(ctl, "_launch", lambda: _FakeProc(7))
        assert ctl.run() == 7
        assert ctl.restarts_used == 3 and ctl.lifetimes == 0
        status = ctl.status()
        assert status["last_exit"] == 7 and not status["trainer_alive"]
        journals.append(_decisions(ctl.journal_path))
        assert all(validate_event(e) == [] for e in
                   read_journal(ctl.journal_path))
    assert journals[0] == journals[1]
    assert [d[1:4] for d in journals[0]] == [
        ("restart", True, -1), ("restart", True, -1), ("abort", False, -1)]


@pytest.mark.parametrize("config,merged", [
    ({"overlap": "1step"}, {"staleness": 2}), ({}, {})])
def test_controller_restart_merge_equal_jax(tmp_path, monkeypatch, config,
                                            merged):
    """A deliberate restart merges the restart-scope fields without
    charging the budget; a merge that cannot build a config is rejected
    and journaled instead."""
    journals = []
    for package in (serve, jserve):
        cfg = dict(name="merge", model="mlp",
                   savePath=str(tmp_path / package.__name__), **config)
        ctl = package.Controller(package.ServeConfig(config=cfg,
                                                     restart_budget=0))
        package.write_control(ctl.control_path,
                              {"version": 1, "staleness": 2})
        codes = iter([package.RESTART_EXIT, 0])
        monkeypatch.setattr(ctl, "_launch", lambda: _FakeProc(next(codes)))
        assert ctl.run() == 0 and ctl.restarts_used == 0
        assert {k: ctl.config[k] for k in merged} == merged
        assert ("staleness" in ctl.config) == bool(merged)
        journals.append([d[:4] + (d[5],) for d in
                         _decisions(ctl.journal_path)])
        # the reasons quote each package's own TrainConfig error
        if not merged:
            reasons = [d[4] for d in _decisions(ctl.journal_path)]
            assert "merge invalid" in reasons[0]
    assert journals[0] == journals[1]


def test_serve_config_and_spec_carry_the_device(tmp_path):
    with pytest.raises(ValueError, match="device"):
        serve.ServeConfig(config={}, device="tpu")
    ctl = serve.Controller(serve.ServeConfig(
        config=dict(name="dev", model="mlp", savePath=str(tmp_path)),
        device="cpu"))
    ctl._write_spec()
    spec = json.load(open(ctl.spec_path))
    assert spec["device"] == "cpu" and spec["config"]["save"] is True
    assert "resume" not in spec["config"]
    ctl = serve.Controller(serve.ServeConfig(config=dict(
        name="card", model="mlp", savePath=str(tmp_path))))
    ctl._write_spec()
    assert json.load(open(ctl.spec_path))["device"] is None


# ------------------------------------------------ serve_torch.py, the daemon

def test_serve_torch_daemon_on_the_cpu(tmp_path):
    """``serve_torch.py run --device cpu``: the endpoint answers
    ``/status`` while the trainer runs and ``/promoted`` once an epoch
    promoted; ``control --stop`` drains it to exit 0; ``verify`` gives 0,
    then 1 after one byte of the manifest is edited."""
    cfg = dict(BASE, name="cli", epochs=100000, savePath=str(tmp_path))
    config = tmp_path / "serve.json"
    config.write_text(json.dumps(cfg))
    daemon = subprocess.Popen(
        [sys.executable, "serve_torch.py", "run", "--config", str(config),
         "--port", "0", "--device", "cpu", "--promote-every", "1",
         "--restart-budget", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    try:
        port = None
        for line in daemon.stdout:
            lines.append(line)
            found = re.search(r"endpoint on http://127\.0\.0\.1:(\d+)", line)
            if found:
                port = int(found.group(1))
                break
        assert port is not None, "".join(lines)
        threading.Thread(target=lambda: lines.extend(daemon.stdout),
                         daemon=True).start()
        deadline = time.time() + 120
        while time.time() < deadline:
            code, body = _get(port, "/status")
            assert code == 200
            if body["trainer_alive"] and _get(port, "/promoted")[0] == 200:
                break
            time.sleep(0.2)
        else:
            pytest.fail("no promoted epoch while the trainer ran:\n"
                        + "".join(lines))
        assert body["lifetimes"] == 1 and body["restart_budget"] == 0
        assert _get(port, "/healthz")[0] == 200
        out = subprocess.run(
            [sys.executable, "serve_torch.py", "control", "--out",
             body["control_path"], "--version", "1", "--stop"],
            cwd=REPO, capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert daemon.wait(timeout=120) == 0, "".join(lines)
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()
    events = _journal(os.path.join(str(tmp_path), "cli_mlp"))
    assert [(e["action"], e["applied"]) for e in of_kind(events, "control")
            ] == [("stop", True)]
    assert of_kind(events, "promotion")
    serving = os.path.join(str(tmp_path), "cli_serving")
    verify = [sys.executable, "serve_torch.py", "verify", serving]
    assert subprocess.run(verify, cwd=REPO, capture_output=True,
                          timeout=60).returncode == 0
    pointer = os.path.join(serving, "MANIFEST.json")
    blob = bytearray(open(pointer, "rb").read())
    at = blob.index(b'"epoch": ') + len(b'"epoch": ')
    blob[at] = ord("9") if blob[at] != ord("9") else ord("8")
    open(pointer, "wb").write(bytes(blob))
    assert subprocess.run(verify, cwd=REPO, capture_output=True,
                          timeout=60).returncode == 1
