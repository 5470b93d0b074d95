"""The port's performance observability against the JAX package's, on the
CPU: the profiler window and spans, the executed-trace parser, program
costs and the cost ledger, the roofline on the H100's peaks.

* ``device_span`` outside a window is a ``nullcontext``; inside
  ``trace()`` its name is a ``user_annotation`` row of the Chrome trace.
* ``train()`` with ``trace_dir`` (the JAX ``tests/test_perfobs.py``
  instrumented-run recipe) captures one window, in epoch
  ``min(trace_epoch, epochs − 1)``, and its parameters are bitwise those of
  the same run without it.  A CPU capture has no device rows: the parser
  raises and ``obs_torch.py profile`` exits 2.
* The JAX fixtures' device intervals and phases laid out as Kineto traces
  (kernel rows, ``cuda_runtime`` launches with correlation ids inside
  ``user_annotation`` ranges): the port's ``overlap_report`` equals JAX's
  on the fixture, counts exactly, seconds to 1e-12.
* ``analyze_program`` on one product: 2·m·n·k FLOPs and the JAX
  extraction's argument and output bytes; the ``CostLedger`` dedup of the
  JAX test.
* Roofline parity on the CPU row at N = 64, D = 512, T = 16 on a ring:
  every hand-model field equal, the boundary bytes equal (the two
  programs take the same arguments on all three backends), ``dense``'s
  FLOPs within 5 % of XLA's count (XLA counts the casts too, about
  1/(2N) of 2·N²·D); the capacity table's state bytes equal.
* The H100 row at ``[256, 273258]``, T = 64: ``fused`` bf16's compute
  bound is 64 steps over K3's ``bound_ms`` at chain (b), 2.318 ms, and
  f32's over 34.21 ms (``PERF.md`` § 6), to 0.1 %.
* The ledger's ``compile`` events of a port run carry the JAX run's
  labels, and the step's FLOPs equal the closed-form count of the MLP's
  products (forward, weight and input gradients) plus the dense mix.
"""

import contextlib
import math
import pathlib

import pytest
import torch

import obs_torch
from matcha_tpu.obs import costs as jcosts
from matcha_tpu.obs import xprof as jxprof
from matcha_tpu.obs.journal import validate_event as jax_validate_event
from matcha_tpu.topology import decompose as jax_decompose
from matcha_tpu.topology import make_graph as jax_make_graph
from matcha_tpu.train import TrainConfig as JaxTrainConfig
from matcha_tpu.train import train as jax_train
from matcha_tpu_torch.obs import costs, xprof
from matcha_tpu_torch.obs.journal import make_event, validate_event
from matcha_tpu_torch.topology import decompose, hypercube_graph, make_graph
from matcha_tpu_torch.train import TrainConfig, train
from matcha_tpu_torch.train import loop
from matcha_tpu_torch.utils import device_span, trace

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
TRACE_FIXTURES = ("trace_overlap_off", "trace_overlap_1step",
                  "trace_overlap_1step_dbuf")

# the JAX tests/test_perfobs.py BASE, pipelined as its instrumented run
BASE = dict(
    name="perf", model="mlp", dataset="synthetic",
    dataset_kwargs={"num_train": 128, "num_test": 32},
    num_workers=8, graphid=5, batch_size=8, epochs=2, lr=0.0,
    warmup=False, momentum=0.0, weight_decay=0.0, matcha=True, budget=0.5,
    seed=3, save=False, sync_init=False, eval_every=1,
    measure_comm_split=True, overlap="1step",
)


# ------------------------------------------------------- window and spans

def test_device_span_is_free_outside_a_window_and_a_range_inside(tmp_path):
    assert isinstance(device_span("comm/step"), contextlib.nullcontext)
    with trace(str(tmp_path / "first"), device="cpu"):
        with device_span("comm/step"):
            torch.ones(8).sum()
    # the span made outside a window records nothing in a later one
    outside = device_span("matcha/sgd")
    with trace(str(tmp_path / "second"), device="cpu"):
        with outside:
            torch.ones(8).sum()
    events = xprof.load_trace_events(
        xprof.find_trace_file(str(tmp_path / "first")))
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert "comm/step" in names
    second = xprof.load_trace_events(
        xprof.find_trace_file(str(tmp_path / "second")))
    assert not [e for e in second if e.get("name") == "matcha/sgd"]


@pytest.fixture(scope="module")
def traced_runs(tmp_path_factory):
    """The port's instrumented run (``trace_dir`` set) with the epoch its
    window opened in, the same run untraced, and the JAX run's journal."""
    trace_dir = str(tmp_path_factory.mktemp("trace"))
    opened, epochs_started = [], [0]
    real_trace, real_batches = loop.trace, loop._epoch_batches

    def counting_batches(*args):
        epochs_started[0] += 1
        return real_batches(*args)

    def recording_trace(log_dir, device=None):
        opened.append(epochs_started[0])
        return real_trace(log_dir, device=device)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(loop, "trace", recording_trace)
        patch.setattr(loop, "_epoch_batches", counting_batches)
        traced = train(TrainConfig(**BASE, trace_dir=trace_dir),
                       device="cpu")
    plain = train(TrainConfig(**BASE), device="cpu")
    ref = jax_train(JaxTrainConfig(**BASE))
    return traced, plain, ref, trace_dir, opened


def test_trace_dir_captures_one_window_in_the_epoch_jax_picks(traced_runs):
    traced, plain, _, trace_dir, opened = traced_runs
    files = [p for p in pathlib.Path(trace_dir).rglob("*") if p.is_file()]
    assert len(files) == 1 and str(files[0]).endswith(".pt.trace.json.gz")
    # JAX train/loop.py:969-970: min(trace_epoch, epochs - 1)
    assert opened == [min(TrainConfig().trace_epoch, BASE["epochs"] - 1)]
    for (name, a), b in zip(traced.state.model.named_parameters(),
                            plain.state.model.parameters()):
        assert torch.equal(a, b), name


def test_cpu_capture_raises_and_the_cli_exits_2(traced_runs):
    trace_dir = traced_runs[3]
    with pytest.raises(xprof.TraceParseError, match="no device rows"):
        xprof.profile_report(trace_dir)
    assert obs_torch.main(["profile", trace_dir]) == 2


def test_profile_errors_on_missing_and_empty_sources(tmp_path):
    with pytest.raises(xprof.TraceParseError, match="no trace at"):
        xprof.profile_report(str(tmp_path / "nowhere"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(xprof.TraceParseError, match="no \\*\\.trace"):
        xprof.profile_report(str(tmp_path / "empty"))
    bad = tmp_path / "bad.trace.json"
    bad.write_text("not json")
    with pytest.raises(xprof.TraceParseError, match="not a readable"):
        xprof.profile_report(str(bad))


# ------------------------------------------------------------ overlap truth

_RANGE = {"comm": "comm/step", "comp": "matcha/fwd_bwd"}


def kineto_like(events):
    """The JAX fixture's device rows as a Kineto trace: each a ``kernel``
    row with a correlation id, launched by a ``cuda_runtime`` row on the
    host thread inside a ``user_annotation`` range named for its phase
    (none for ``other``).  The fixture's host-side ``comm/`` shadow row
    becomes a ``cpu_op`` row, which must be ignored."""
    device_pids = {e["pid"] for e in events if e.get("ph") == "M"
                   and e.get("name") == "process_name"
                   and "/device:" in e["args"]["name"]}
    out = [{"ph": "M", "name": "process_name", "pid": 1,
            "args": {"name": "python"}}]
    for i, e in enumerate(events):
        if e.get("ph") != "X":
            continue
        if e["pid"] not in device_pids:
            out.append({"ph": "X", "cat": "cpu_op", "name": e["name"],
                        "pid": 1, "tid": 1, "ts": e["ts"], "dur": e["dur"]})
            continue
        host_ts = 100.0 * i
        out.append({"ph": "X", "cat": "kernel", "name": e["name"], "pid": 0,
                    "tid": e["tid"], "ts": e["ts"], "dur": e["dur"],
                    "args": {"correlation": i, "device": 0}})
        out.append({"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                    "ts": host_ts + 2.0, "dur": 3.0,
                    "args": {"correlation": i}})
        phase = jxprof._phase_of(e)
        if phase in _RANGE:
            out.append({"ph": "X", "cat": "user_annotation",
                        "name": _RANGE[phase], "pid": 1, "tid": 1,
                        "ts": host_ts, "dur": 10.0})
    return out


@pytest.mark.parametrize("name", TRACE_FIXTURES)
def test_overlap_report_equals_jax_on_the_fixtures(name):
    path = str(FIXTURES / f"{name}.trace.json.gz")
    want = jxprof.profile_report(path)
    got = xprof.overlap_report(kineto_like(jxprof.load_trace_events(path)))
    assert got["rows"] == want["rows"]
    for key in ("comm_seconds", "comp_seconds", "other_seconds",
                "compute_seconds", "overlap_seconds", "overlap_fraction"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert validate_event(make_event("profile", 0.0, **got)) == []


def _kernel(corr, ts, dur, tid=7):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "pid": 0,
            "tid": tid, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": 1, "tid": tid, "ts": ts, "dur": 1.0,
            "args": {"correlation": corr}}


def _range(name, ts, dur, tid=1, cat="user_annotation", pid=1):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur}


def test_phase_rules_innermost_other_thread_and_missing_launch():
    events = [
        # comm/step nested in a host phase: the innermost range wins
        _range("matcha/checkpoint", 0.0, 100.0),
        _range("comm/step", 10.0, 20.0), _launch(1, 15.0),
        _kernel(1, 1000.0, 10.0),
        # a backward launch on autograd's thread, inside the step
        # thread's fwd_bwd range: comp
        _range("matcha/fwd_bwd", 200.0, 100.0), _launch(2, 250.0, tid=2),
        _kernel(2, 1010.0, 10.0),
        # no launch row: other, whatever device-side range encloses it
        _range("comm/step", 1019.0, 20.0, tid=7, cat="gpu_user_annotation",
               pid=0),
        _kernel(3, 1020.0, 10.0),
        # a launch in no range: other
        _launch(4, 500.0), _kernel(4, 1030.0, 10.0),
    ]
    rep = xprof.overlap_report(events)
    assert rep["rows"] == {"comm": 1, "comp": 1, "other": 2}
    assert rep["comm_seconds"] == pytest.approx(10e-6, abs=1e-12)
    assert rep["overlap_fraction"] == pytest.approx(0.0, abs=1e-12)
    # no comm row: no claim either way; no complete device row: loud
    rep = xprof.overlap_report([_launch(1, 0.0), _kernel(1, 5.0, 3.0)])
    assert rep["overlap_fraction"] is None
    with pytest.raises(xprof.TraceParseError, match="no complete"):
        xprof.overlap_report([{"ph": "i", "cat": "kernel", "pid": 0,
                               "ts": 1.0}])


# ------------------------------------------------------------ program costs

def test_analyze_program_counts_one_product_like_jax():
    import jax
    import jax.numpy as jnp

    m, k, n = 64, 128, 32
    want = jcosts.analyze_program(
        jax.jit(lambda a, b: a @ b), jax.ShapeDtypeStruct((m, k), jnp.float32),
        jax.ShapeDtypeStruct((k, n), jnp.float32), label="dot")
    a, b = torch.ones(m, k), torch.ones(k, n)
    got = costs.analyze_program(lambda x, y: x @ y, a, b, label="dot")
    assert got["flops"] == want["flops"] == 2.0 * m * n * k
    for key in ("arg_bytes", "out_bytes", "hbm_bytes", "alias_bytes"):
        assert got[key] == want[key], key
    assert got["peak_bytes"] >= got["hbm_bytes"]
    assert got["compile_seconds"] > 0 and got["arg_shardings"] == ["cpu"]
    for validate in (validate_event, jax_validate_event):
        assert validate(make_event("compile", 1.0, **got)) == []
    assert got["fingerprint"] == costs.program_fingerprint("dot", (a, b))
    assert costs.program_fingerprint("dot", (a, a)) != got["fingerprint"]
    # an in-place update is aliased: its output crosses no extra bytes
    inplace = costs.analyze_program(lambda x: x.mul_(2.0), torch.ones(10))
    assert (inplace["arg_bytes"], inplace["out_bytes"],
            inplace["alias_bytes"], inplace["hbm_bytes"]) == (40, 40, 40, 40)


def test_cost_ledger_dedups_like_jax():
    events = []

    def log(kind, **detail):
        events.append(make_event(kind, 0.0, **detail))
        return events[-1]

    ledger = costs.CostLedger(log)

    def f(x):
        return (x * x).sum()

    def journaled(label, fn, x):
        before = len(events)
        out = ledger.call(label, fn, x)
        assert float(out) == float((x * x).sum())  # the call's own output
        return len(events) > before

    assert journaled("probe", f, torch.ones(16))
    assert not journaled("probe", f, torch.full((16,), 2.0))  # same program
    assert journaled("probe", f, torch.ones(8))  # a new shape

    def g(x):  # a rebuilt program: a new measurement
        return (x * x).sum()

    assert journaled("probe", g, torch.ones(16))
    assert len(events) == 3
    assert ledger.last_fingerprint("probe") == events[-1]["fingerprint"]
    assert ledger.last_fingerprint("unknown") is None
    assert (ledger.traces("probe", f), ledger.traces("probe", g)) == (2, 1)
    assert ledger.programs == events


# ---------------------------------------------------------------- roofline

N, D, T = 64, 512, 16
MODEL_KEYS = ("model_flops", "model_hbm_bytes", "model_stream_hbm_bytes")


@pytest.fixture(scope="module")
def ring():
    return (decompose(make_graph("ring", N, seed=1), N, seed=1),
            jax_decompose(jax_make_graph("ring", N, seed=1), N, seed=1))


@pytest.mark.parametrize("wire", ["bf16", "f32"])
@pytest.mark.parametrize("backend", ["dense", "fused", "perm"])
def test_roofline_parity_on_the_cpu_row(ring, backend, wire):
    dec, jdec = ring
    got = costs.roofline_report(N, D, dec, wire_dtype=wire, chip="cpu",
                                backend=backend, t_steps=T)
    assert got["provisional"] and got["chip"] == "cpu-provisional"
    if backend == "dense":
        want = jcosts.roofline_report(N, D, jdec, wire_dtype=wire,
                                      chip="cpu", backend="dense")
        # XLA also counts the casts and the W build, about 1/(2N) more
        assert got["flops_per_step"] == pytest.approx(
            want["flops_per_step"], rel=0.05)
        assert got["flops_per_step"] == 2.0 * N * N * D
    else:
        want = jcosts.gossip_chain_costs(N, D, jdec, backend=backend,
                                         wire_dtype=wire, t_steps=T)
        assert got["stream_hbm_bytes_per_step"] == \
            want["stream_hbm_bytes_per_step"]
        assert got["t_steps"] == want["t_steps"] == T
    for key in MODEL_KEYS:
        if key in want:
            assert got[key] == want[key], key
    # the same arguments on both sides: x and the stream (W stack, or the
    # [T, M] weights and the two [M, N] tables), and the output
    assert got["hbm_bytes_per_step"] == want["hbm_bytes_per_step"] \
        if "hbm_bytes_per_step" in want else want["hbm_bytes"]
    assert math.isfinite(got["ceiling_steps_per_sec"])


@pytest.mark.parametrize("backend,every", [("dense", 1), ("dense", 4),
                                           ("perm", 1), ("perm", 4)])
def test_elision_epoch_costs_equal_jax(ring, backend, every):
    dec, jdec = ring
    got = costs.elision_epoch_costs(N, D, dec, backend=backend, t_steps=T,
                                    local_every=every)
    want = jcosts.elision_epoch_costs(N, D, jdec, backend=backend,
                                      t_steps=T, local_every=every)
    for key in ("exec_steps", "gossip_hbm_bytes_per_epoch",
                "gossip_hbm_bytes_per_step"):
        assert got[key] == want[key], key


def test_capacity_state_bytes_equal_jax():
    got = costs.capacity_report(1000, workers=(8, 4), chip="cpu")
    want = jcosts.capacity_report(1000, workers=(8, 4), chip="cpu")
    assert [(r["communicator"], r["n"], r["state_bytes"], r["buffers"])
            for r in got["rows"]] == \
        [(r["communicator"], r["n"], r["state_bytes"], r["buffers"])
         for r in want["rows"]]
    big = costs.capacity_report(25_560_000, workers=(256, 64), chip="h100")
    rows = {(r["communicator"], r["n"]): r for r in big["rows"]}
    assert rows[("decen", 256)]["chips_needed"] == 1  # 52.3 GB / 80 GB
    assert not rows[("choco", 256)]["fits_one_chip"]  # 104.7 GB
    assert "52.35 GB" in costs.render_capacity_markdown(big)


@pytest.mark.parametrize("wire,bound_ms", [("bf16", 2.318), ("f32", 34.21)])
def test_h100_row_prices_chain_b_at_k3s_bound(wire, bound_ms):
    n, d, t = 256, 273258, 64
    dec = decompose(hypercube_graph(n), n, seed=1)
    rep = costs.roofline_report(n, d, dec, wire_dtype=wire, chip="h100",
                                backend="fused", t_steps=t,
                                measured_steps_per_sec=14840.0)
    assert rep["compute_bound_steps_per_sec"] == pytest.approx(
        t / (bound_ms * 1e-3), rel=1e-3)
    assert rep["bound"] == "compute" and not rep["provisional"]
    assert (rep["peak_tflops"], rep["peak_dtype"]) == (
        (989.0, "bf16") if wire == "bf16" else (67.0, "f32"))
    assert rep["measured_vs_ceiling_backend"] == "fused"
    assert f"{rep['ceiling_steps_per_sec']:.1f}" in \
        costs.render_roofline_markdown(rep)


@pytest.mark.parametrize("backend", ["fused", "perm"])
def test_a_metered_kernel_count_is_no_cross_check(ring, monkeypatch,
                                                  backend):
    """A launched kernel reports its operations through the meter, from the
    same function the roofline's hand model calls: such a count is the
    model itself, so the report gives no counted-vs-model ratio.  The plain
    version's products are counted, and keep theirs."""
    from matcha_tpu_torch import _kernels, parallel

    dec, _ = ring
    plain = costs.roofline_report(N, D, dec, chip="cpu", backend=backend,
                                  t_steps=T)
    assert plain["kernel_flops_per_step"] == 0.0
    assert plain["flops_vs_model"] == (plain["extracted_flops_per_step"]
                                       / plain["model_flops"])

    def fused_launch(x, stack, **_):  # what the counter sees of a launch
        _kernels.add_kernel_flops(_kernels.fused_gossip_flops(
            x.shape[0], x.shape[1], stack.shape[0]))
        return torch.empty_like(x)

    def perm_launch(x, w, pi, pr, **_):
        _kernels.add_kernel_flops(_kernels.perm_gossip_flops(
            w.shape[1], x.shape[0], x.shape[1], w.shape[0]))
        return torch.empty_like(x)

    name = f"{backend}_gossip_plain"
    monkeypatch.setattr(parallel, name,
                        fused_launch if backend == "fused" else perm_launch)
    rep = costs.roofline_report(N, D, dec, chip="cpu", backend=backend,
                                t_steps=T)
    assert rep["extracted_flops_per_step"] == rep["kernel_flops_per_step"] \
        == rep["model_flops"] == plain["model_flops"]
    assert rep["flops_vs_model"] is None
    assert rep["ceiling_steps_per_sec"] == plain["ceiling_steps_per_sec"]
    assert "| — |" in costs.render_roofline_markdown(rep)


def test_one_chip_table_and_the_card_rule():
    from chip_smoke import BF16_OPS_PER_S
    from matcha_tpu_torch.probes import perm_bench

    assert set(costs.CHIP_PEAKS) == {"h100"}  # no TPU rows
    assert costs.resolve_chip("NVIDIA H100 80GB HBM3") == ("h100",
                                                          costs.H100)
    assert costs.resolve_chip("cpu")[1] is costs.CPU_PROVISIONAL
    with pytest.raises(ValueError, match="unknown chip"):
        costs.resolve_chip("v5e")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA card"):
            costs.resolve_chip(None)
        assert obs_torch.main(["roofline", "--workers", "4", "--dim", "64",
                               "--topology", "ring"]) == 2
    # every bound in the repo divides by this table's numbers
    assert perm_bench.HBM_BYTES_PER_S == costs.H100.peak_gbps * 1e9 == 3.35e12
    assert perm_bench.FP32_OPS_PER_S == costs.H100.peak_tflops_fp32 * 1e12
    assert BF16_OPS_PER_S == costs.H100.peak_tflops * 1e12 == 989e12
    assert costs.chip_peaks("NVIDIA H100 80GB HBM3") == (989.0, 3350.0)
    assert costs.chip_peaks("cpu") == (None, None)


def test_cli_roofline_and_capacity_on_the_cpu_row(tmp_path, capsys):
    md = tmp_path / "roofline.md"
    assert obs_torch.main(["roofline", "--workers", "4", "--topology",
                           "ring", "--model", "mlp", "--dataset",
                           "synthetic", "--chip", "cpu", "--md",
                           str(md)]) == 0
    out = capsys.readouterr().out
    assert "Automatic roofline" in out and "provisional" in out
    assert md.read_text().startswith("# Automatic roofline")
    cap = tmp_path / "capacity.md"
    assert obs_torch.main(["capacity", "--dim", "1000", "--workers", "8,4",
                           "--chip", "cpu", "--md", str(cap)]) == 0
    assert "| decen | 8 |" in cap.read_text()
    assert obs_torch.main(["roofline", "--workers", "4", "--topology",
                           "ring", "--dim", "512", "--chip", "cpu",
                           "--backend", "both"]) == 0


# ------------------------------------------------------- the ledger in train

def test_compile_events_cover_jaxs_labels_with_closed_form_flops(
        traced_runs):
    traced, _, ref, _, _ = traced_runs
    got = [e for e in traced.recorder.events if e["kind"] == "compile"]
    want = [e for e in ref.recorder.events if e["kind"] == "compile"]
    assert [e["label"] for e in got] == [e["label"] for e in want]
    assert {"epoch_scan", "gossip_chain", "evaluate", "drain"} <= \
        {e["label"] for e in got}
    keys = [(e["label"], e["fingerprint"]) for e in got]
    assert len(keys) == len(set(keys))
    for e in got:
        assert validate_event(e) == [] and len(e["fingerprint"]) == 12
        assert e["hbm_bytes"] > 0 and e["peak_bytes"] > 0
        assert e["compile_seconds"] > 0
    # the step: the MLP's products (forward, weight gradients, and input
    # gradients of the layers after the first) and the dense mix W_t @ x
    backend = next(e for e in traced.recorder.events
                   if e["kind"] == "backend")
    assert backend["chosen"] == "dense"
    n, b, widths = BASE["num_workers"], BASE["batch_size"], \
        [(784, 500), (500, 500), (500, 10)]
    dim = sum(i * o + o for i, o in widths)
    products = sum(i * o for i, o in widths)
    closed = 2.0 * n * b * (2 * products + products - 784 * 500) \
        + 2.0 * n * n * dim
    step = next(e for e in got if e["label"] == "epoch_scan")
    assert step["flops"] == closed
    # no telemetry, no ledger
    quiet = train(TrainConfig(**{**BASE, "epochs": 1, "telemetry": False}),
                  device="cpu")
    assert not [e for e in quiet.recorder.events if e["kind"] == "compile"]


def test_retrace_names_the_added_program(monkeypatch):
    """A loader that drops a batch from epoch 1 on changes the step's
    input signature: the retrace event carries the fingerprint of the
    compile event of the program that was added (JAX's retrace recipe)."""
    from matcha_tpu_torch.data import WorkerBatches

    real = WorkerBatches.epoch_indices

    def drifting(self, epoch):
        batches = [idx[:, :-1] if epoch >= 1 else idx
                   for idx in real(self, epoch)]
        return batches

    monkeypatch.setattr(WorkerBatches, "epoch_indices", drifting)
    result = train(TrainConfig(**{**BASE, "measure_comm_split": False,
                                  "eval_every": 0, "overlap": "off"}),
                   device="cpu")
    retrace = [e for e in result.recorder.events if e["kind"] == "retrace"]
    compiles = {e["fingerprint"]: e for e in result.recorder.events
                if e["kind"] == "compile" and e["label"] == "epoch_scan"}
    assert len(retrace) == 1 and retrace[0]["traces"] == 2
    assert retrace[0]["fingerprint"] in compiles and len(compiles) == 2
    assert validate_event(retrace[0]) == []
