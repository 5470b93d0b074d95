"""The port's bounded-staleness pipeline against the JAX package's, on the
CPU: the contraction bound and its α damping (``plan/spectral.py``), the
k-deep ring through ``train()``, checkpoints that carry the ring, and the
reconciliation of a restored ring with the resuming run's depth.

* ``stale_contraction_rho`` and ``stale_alpha_rescale`` against the JAX
  functions on zoo graphs 0 and 5, K ∈ {1, 2, 4}, L ∈ {1, 2}, an f32 and a
  bf16 wire: within 1e-12 relative (the same numpy on both sides; the
  scale comes out of the same bounded scalar search).  The spec parsers
  raise on the same bad inputs.
* ``train()`` with ``staleness=2, local_steps=2`` against the JAX
  ``train()`` on the acceptance configuration, at the acceptance run's
  bars (loss and disagreement within 1e-4 relative, test accuracy within
  one example); the returned state drained, the worker mean where the
  undrained state held it (the in-flight deltas have zero column mean:
  within 1e-6 of the parameters' scale).
* A resumed run at the same depth is bitwise the uninterrupted one: the
  final parameters, momentum and history, and the ring in the last
  checkpoint.  A ring resumes at another depth, eagerly and from an eager
  checkpoint; a checkpoint written without ``mix_pending`` restores as
  eager.
* ``_reconcile_mix_pending`` against the JAX function on the same arrays
  and cursor: the drains add the same deltas in the same order (bitwise),
  the rebuilt ages are equal.
"""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from matcha_tpu import topology as jtp
from matcha_tpu.communicator import make_decen as jax_make_decen
from matcha_tpu.ops import WorkerFlattener as JaxWorkerFlattener
from matcha_tpu.plan import spectral as jax_spectral
from matcha_tpu.schedule import matcha_schedule as jax_matcha_schedule
from matcha_tpu.train.loop import \
    _reconcile_mix_pending as jax_reconcile_mix_pending
from matcha_tpu.train.state import TrainState as JaxTrainState
from matcha_tpu_torch import plan
from matcha_tpu_torch import topology as tp
from matcha_tpu_torch.communicator import make_decen
from matcha_tpu_torch.ops import WorkerFlattener
from matcha_tpu_torch.schedule import matcha_schedule
from matcha_tpu_torch.train import TrainConfig, TrainState, loop, train
from matcha_tpu_torch.train.checkpoint import (
    CHECKPOINT_FILE,
    restore_checkpoint,
    save_checkpoint,
)
from test_torch_overlap import check_against_jax, train_against_jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module (see test_torch_overlap.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- the predictor

def _plan_inputs(gid):
    sched = matcha_schedule(tp.select_graph(gid), tp.graph_size(gid),
                            iterations=4, budget=0.5, seed=3)
    return sched.laplacians(), sched.probs, float(sched.alpha)


@pytest.mark.parametrize("wire", [None, "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("local_steps", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("gid", [0, 5])
def test_stale_contraction_rho_matches_jax(gid, k, local_steps, wire):
    ls, probs, alpha = _plan_inputs(gid)
    got = plan.stale_contraction_rho(ls, probs, alpha, wire_dtype=wire,
                                     staleness=k, local_steps=local_steps)
    want = jax_spectral.stale_contraction_rho(
        ls, probs, alpha, wire_dtype=wire, staleness=k,
        local_steps=local_steps)
    assert got == pytest.approx(want, rel=1e-12, abs=0)


@pytest.mark.parametrize("local_steps", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("gid", [0, 5])
def test_stale_alpha_rescale_matches_jax(gid, k, local_steps):
    ls, probs, alpha = _plan_inputs(gid)
    got = plan.stale_alpha_rescale(ls, probs, alpha, staleness=k,
                                   local_steps=local_steps)
    want = jax_spectral.stale_alpha_rescale(ls, probs, alpha, staleness=k,
                                            local_steps=local_steps)
    assert got == pytest.approx(want, rel=1e-12, abs=0)
    if -(-k // local_steps) == 1:
        assert got[0] == 1.0  # the one-event pipeline is never damped


def test_staleness_specs_parse_like_jax():
    assert plan.normalize_staleness({1: 1.0, 4: 3.0}) == {1: 0.25, 4: 0.75}
    for text in ("2", "1:0.75,4:0.25", " 3:1, 1:1 ,"):
        assert plan.parse_staleness_spec(text) \
            == jax_spectral.parse_staleness_spec(text)
    for bad in (0, -1, {0: 1.0}, {2: -1.0}, {}, [(1.5, 1.0)], "x:y", "0",
                "1:0"):
        for lib in (plan, jax_spectral):
            with pytest.raises(ValueError):
                (lib.parse_staleness_spec(bad) if isinstance(bad, str)
                 else lib.normalize_staleness(bad))
    ls, probs, alpha = _plan_inputs(0)
    for lib in (plan, jax_spectral):
        with pytest.raises(ValueError, match="overlap"):
            lib.stale_contraction_rho(ls, probs, alpha, overlap="off",
                                      staleness=2)
        with pytest.raises(ValueError, match="local_steps"):
            lib.stale_contraction_rho(ls, probs, alpha, local_steps=0)
        with pytest.raises(ValueError, match="wire_dtype"):
            lib.wire_quantization_eps("fp8")


# ------------------------------------------------------------ train() vs JAX

@pytest.fixture(scope="module")
def ring_runs():
    drained = []
    drain = loop._drain_mix_pending

    def recording(state, communicator, flattener):
        flat = flattener.flatten(state.params)
        drained.append((flat.mean(0), state.mix_pending.clone()))
        return drain(state, communicator, flattener)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(loop, "_drain_mix_pending", recording)
        out = train_against_jax(overlap="1step", staleness=2, local_steps=2)
    return out + (drained,)


def test_ring_train_matches_jax(ring_runs):
    port, ref, _, _ = ring_runs
    check_against_jax(port, ref)


def test_ring_train_drains_and_keeps_the_worker_mean(ring_runs):
    _, _, result, drained = ring_runs
    state = result.state
    assert state.mix_pending.shape[:2] == (8, 2)
    assert not state.mix_pending.any()
    assert torch.equal(state.mix_ages, torch.full((8, 2), -1,
                                                  dtype=torch.int32))
    (mean_before, ring), = drained
    assert ring.any()  # a real delta was in flight at the end
    flat = torch.cat([p.detach().reshape(8, -1)
                      for _, p in sorted(state.model.named_parameters())],
                     dim=1)
    scale = float(flat.abs().max())
    assert float(ring.mean(0).abs().max()) <= 1e-6 * scale
    assert float((flat.mean(0) - mean_before).abs().max()) <= 1e-6 * scale


# -------------------------------------------------------- checkpoint, resume

RUN = dict(model="mlp", dataset="synthetic", num_workers=8, graphid=0,
           batch_size=16, lr=0.1, warmup=False, seed=3, gossip_backend="perm",
           measure_comm_split=False, eval_every=0,
           dataset_kwargs={"num_train": 384, "num_test": 32,
                           "shape": (8, 8, 1)})  # 3 steps an epoch


def _cfg(root, name, **over):
    return TrainConfig(**{**RUN, "name": name, "savePath": str(root),
                          **over})


def _final(result):
    state = result.state
    out = {f"p.{k}": v for k, v in state.model.named_parameters()}
    for k, p in state.model.named_parameters():
        out[f"m.{k}"] = state.optimizer.state[p]["momentum_buffer"]
    return out


def _saved(root, name, epoch):
    return torch.load(os.path.join(root, f"{name}_ckpt", str(epoch),
                                   CHECKPOINT_FILE), weights_only=True)


@pytest.mark.parametrize("pipeline", [
    dict(overlap="1step"), dict(overlap="1step", staleness=2),
    dict(overlap="1step", staleness=2, local_steps=2)],
    ids=["1step", "k2", "k2-l2"])
def test_resumed_pipeline_is_bitwise_the_uninterrupted_one(tmp_path,
                                                           pipeline):
    whole = train(_cfg(tmp_path / "whole", "run", epochs=3,
                       checkpoint_every=1, **pipeline), device="cpu")
    train(_cfg(tmp_path / "cut", "run", epochs=1, checkpoint_every=1,
               **pipeline), device="cpu")
    rest = train(_cfg(tmp_path / "cut", "run", epochs=3, checkpoint_every=1,
                      **pipeline),
                 resume_dir=str(tmp_path / "cut" / "run_ckpt"), device="cpu")
    assert rest.state.step == whole.state.step == 9
    want, got = _final(whole), _final(rest)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for a, b in zip(whole.history[1:], rest.history):
        assert (a["loss"], a["disagreement"]) == (b["loss"], b["disagreement"])
    # the in-flight state of the last epoch, as its checkpoint holds it
    ring_whole = _saved(tmp_path / "whole", "run", 2)["mix_pending"]
    ring_rest = _saved(tmp_path / "cut", "run", 2)["mix_pending"]
    assert ring_whole.any() and torch.equal(ring_whole, ring_rest)


@pytest.fixture(scope="module")
def ring_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("ring")
    train(_cfg(root, "k2", epochs=1, checkpoint_every=1, overlap="1step",
               staleness=2), device="cpu")
    return root


@pytest.mark.parametrize("over,shape", [
    (dict(overlap="1step", staleness=4), (8, 4)),
    (dict(overlap="1step"), (8,)),
    (dict(), None)], ids=["k4", "1step", "off"])
def test_ring_resumes_at_another_depth(ring_checkpoint, over, shape):
    saved = _saved(ring_checkpoint, "k2", 0)["mix_pending"]
    assert saved.shape[:2] == (8, 2) and saved.any()
    r = train(_cfg(ring_checkpoint, f"to-{shape}", epochs=2, **over),
              resume_dir=str(ring_checkpoint / "k2_ckpt"), device="cpu")
    assert [h["epoch"] for h in r.history] == [1]
    assert np.isfinite(r.history[0]["loss"])
    pend = r.state.mix_pending
    if shape is None:
        assert pend == () and r.state.mix_ages == ()
    else:
        assert tuple(pend.shape[:-1]) == shape and not pend.any()


def test_eager_checkpoint_resumes_into_a_ring(tmp_path):
    train(_cfg(tmp_path, "eager", epochs=1, checkpoint_every=1),
          device="cpu")
    assert _saved(tmp_path, "eager", 0)["mix_pending"] == ()
    r = train(_cfg(tmp_path, "up", epochs=2, overlap="1step", staleness=2),
              resume_dir=str(tmp_path / "eager_ckpt"), device="cpu")
    assert r.state.mix_pending.shape[:2] == (8, 2)
    assert np.isfinite(r.history[0]["loss"])


def test_checkpoint_without_mix_pending_restores_as_eager(tmp_path):
    """A file written before the pipelined schedule was ported has no
    ``mix_pending`` key; a pipelined run resumes from it with a fresh
    pipeline."""
    first = train(_cfg(tmp_path, "old", epochs=1, checkpoint_every=1,
                       overlap="1step"), device="cpu")
    assert first.state.mix_pending.shape[0] == 8
    path = tmp_path / "old_ckpt" / "0" / CHECKPOINT_FILE
    payload = torch.load(path, weights_only=True)
    del payload["mix_pending"]
    torch.save(payload, path)
    os.remove(tmp_path / "old_ckpt" / "digest-0.json")  # now unverifiable
    restored, epoch = restore_checkpoint(str(tmp_path / "old_ckpt"),
                                         first.state)
    assert epoch == 0 and restored.mix_pending == ()
    r = train(_cfg(tmp_path, "old", epochs=2, overlap="1step"),
              resume_dir=str(tmp_path / "old_ckpt"), device="cpu")
    assert r.state.mix_pending.shape[0] == 8
    assert np.isfinite(r.history[0]["loss"])


def test_checkpoint_round_trips_the_ring(tmp_path):
    r = train(_cfg(tmp_path, "trip", epochs=1, overlap="1step",
                   staleness=3), device="cpu")
    ring = torch.randn(r.state.mix_pending.shape)
    r.state.mix_pending = ring.clone()
    save_checkpoint(str(tmp_path / "ck"), r.state, 0)
    r.state.mix_pending = ()
    restored, _ = restore_checkpoint(str(tmp_path / "ck"), r.state)
    assert torch.equal(restored.mix_pending, ring)
    assert restored.mix_ages == ()


# ------------------------------------------------- the reconcile against JAX

SIZE = 8


class _Params(nn.Module):
    """A model of one worker-stacked parameter ``w``: the port's train
    state needs a module, the JAX one a dict."""

    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w.copy()))


def _both_states(pending, cursor, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(SIZE, 4, 3)).astype(np.float32)
    model = _Params(w)
    port = TrainState(model=model, optimizer=None, comm_carry=(),
                      step=cursor,
                      mix_pending=(() if isinstance(pending, tuple)
                                   else torch.from_numpy(pending.copy())))
    ref = JaxTrainState(params={"w": jnp.asarray(w)}, batch_stats={},
                        opt_state={}, comm_carry=(),
                        step=jnp.asarray(cursor, jnp.int32),
                        mix_pending=(() if isinstance(pending, tuple)
                                     else jnp.asarray(pending)))
    return (port, WorkerFlattener(dict(model.named_parameters())),
            ref, JaxWorkerFlattener(ref.params))


@functools.lru_cache(maxsize=None)
def _comms():
    port = make_decen(matcha_schedule(tp.select_graph(0), SIZE, 4,
                                      budget=0.5, seed=3), backend="gather",
                      device="cpu")
    ref = jax_make_decen(jax_matcha_schedule(jtp.select_graph(0), SIZE, 4,
                                             budget=0.5, seed=3), backend="gather")
    return port, ref


@pytest.mark.parametrize("saved", ["eager", "1step", "ring3"])
@pytest.mark.parametrize("target", [("off", 1), ("1step", 1), ("1step", 2),
                                    ("1step", 3)],
                         ids=["off", "1step", "k2", "k3"])
@pytest.mark.parametrize("cursor", [0, 2, 7])
def test_reconcile_matches_jax(saved, target, cursor):
    rng = np.random.default_rng(4)
    pending = {"eager": (),
               "1step": rng.normal(size=(SIZE, 12)).astype(np.float32),
               "ring3": rng.normal(size=(SIZE, 3, 12)).astype(np.float32),
               }[saved]
    port, flattener, ref, jax_flattener = _both_states(pending, cursor)
    port_comm, jax_comm = _comms()
    overlap, staleness = target
    got = loop._reconcile_mix_pending(port, overlap, port_comm, flattener,
                                      SIZE, staleness=staleness)
    want = jax_reconcile_mix_pending(ref, overlap, jax_comm, jax_flattener,
                                     SIZE, staleness=staleness)
    assert np.array_equal(got.model.w.detach().numpy(),
                          np.asarray(want.params["w"]))
    for mine, theirs in ((got.mix_pending, want.mix_pending),
                         (got.mix_ages, want.mix_ages)):
        if isinstance(theirs, tuple):
            assert mine == ()
        else:
            assert np.array_equal(mine.numpy(), np.asarray(theirs))
    if saved != "eager" and (overlap, staleness) != \
            ("1step", 1 if saved == "1step" else 3):
        # a drain: the worker mean stays (the deltas' column means are 0
        # only for real mixing deltas, so compare with the added means)
        before = ref.params["w"].reshape(SIZE, -1).mean(0)
        added = np.asarray(pending).reshape(SIZE, -1, 12).sum(1).mean(0)
        np.testing.assert_allclose(
            got.model.w.detach().reshape(SIZE, -1).mean(0).numpy(),
            np.asarray(before) + added, rtol=1e-5, atol=1e-5)


def test_reconcile_keeps_a_same_depth_ring_in_place():
    ring = np.random.default_rng(5).normal(size=(SIZE, 3, 12)) \
        .astype(np.float32)
    port, flattener, _, _ = _both_states(ring, 7)
    kept = port.mix_pending
    out = loop._reconcile_mix_pending(port, "1step", _comms()[0], flattener,
                                      SIZE, staleness=3)
    assert out.mix_pending is kept
    assert sorted(out.mix_ages[0].tolist()) == [1, 2, 3]


def test_config_no_longer_lists_the_pipeline_as_unported():
    from matcha_tpu_torch.train.config import _UNPORTED

    assert not {"overlap", "staleness", "local_steps"} & set(_UNPORTED)
    cfg = dataclasses.replace(TrainConfig(**RUN), overlap="1step",
                              staleness=3, local_steps=2)
    assert (cfg.overlap, cfg.staleness, cfg.local_steps) == ("1step", 3, 2)
