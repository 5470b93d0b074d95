"""The port's planlint against the JAX package's
(``matcha_tpu/analysis/planlint.py``), on the CPU.

Both sides re-derive every claim of an artifact with the same numpy code
(the port's copies of the topology builders and solvers), so their
verdicts are compared as whole records: rule, path, line, column and
message, in order.  The inputs are every committed plan and link-costs
artifact under ``benchmarks/`` (read, never written) and the tamperings of
``tests/test_dataflow.py:611``, each written to a temporary directory.
"""

import copy
import json
import math
import os
import pathlib

import pytest

from matcha_tpu.analysis import planlint as jlint
from matcha_tpu_torch.analysis import planlint as plint
from matcha_tpu_torch.analysis import (
    PLAN_CHECKS,
    Violation,
    discover_plan_files,
    lint_plan_paths,
    render_plan_text,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
PLAN_DIR = REPO / "benchmarks"


def _records(violations):
    return [(v.rule, v.path, v.line, v.col, v.message) for v in violations]


@pytest.fixture(scope="module")
def committed():
    return {f.name: json.loads(f.read_text())
            for f in discover_plan_files([PLAN_DIR])}


def _plan(committed):
    return next(d for d in committed.values()
                if str(d.get("format", "")).startswith("matcha_tpu.plan"))


def _costs(committed):
    return next(d for d in committed.values()
                if str(d.get("format", "")).startswith(
                    "matcha_tpu.link_costs"))


def test_the_committed_artifacts_verify_alike():
    got, files = lint_plan_paths([PLAN_DIR])
    want, jfiles = jlint.lint_plan_paths([PLAN_DIR])
    assert files == jfiles and len(files) >= 2
    assert _records(got) == _records(want) == []
    assert render_plan_text(got, files) == jlint.render_plan_text(want,
                                                                  jfiles)


def test_checks_and_record_match_jax():
    assert PLAN_CHECKS == jlint.PLAN_CHECKS
    assert set(PLAN_CHECKS) == {f"PL{i:03d}" for i in range(1, 12)}
    from matcha_tpu.obs.attribution import LINK_COSTS_FORMAT

    assert plint.LINK_COSTS_FORMAT == LINK_COSTS_FORMAT
    v = Violation("PL001", "a.json", 0, 0, "m")
    assert v.to_json() == {"rule": "PL001", "path": "a.json", "line": 0,
                           "col": 0, "message": "m"}
    assert v.key() == ("PL001", "a.json", 0)


def _nan_alpha(d):
    d["chosen"]["alpha"] = math.nan


PLAN_TAMPERINGS = {
    "alpha_out_of_window": (
        lambda d: d["chosen"].__setitem__("alpha", d["chosen"]["alpha"] * 50),
        "PL005"),
    "rho_edited": (lambda d: d["chosen"].__setitem__("rho", 0.5), "PL006"),
    "probs_over_one": (
        lambda d: d["chosen"].__setitem__(
            "probs", [1.5] * len(d["chosen"]["probs"])), "PL007"),
    "chosen_not_first": (
        lambda d: d.__setitem__("chosen", copy.deepcopy(d["candidates"][-1])),
        "PL008"),
    "workers_edited": (
        lambda d: d["chosen"].__setitem__("num_workers", 15), "PL002"),
    "probs_missing": (lambda d: d["chosen"].pop("probs"), "PL001"),
    "foreign_format": (lambda d: d.__setitem__("format", "nope/9"), "PL001"),
    "nan_alpha": (_nan_alpha, "PL005"),
    "steps_edited": (
        lambda d: d["chosen"].__setitem__("steps_to_target", 1.0), "PL006"),
    "fraction_edited": (
        lambda d: d["chosen"].__setitem__("expected_comm_fraction", 0.9),
        "PL006"),
    "graph_unknown": (
        lambda d: d["chosen"].update(graphid=99, topology=None), "PL002"),
}


@pytest.mark.parametrize("name", sorted(PLAN_TAMPERINGS))
def test_plan_tamperings_give_jax_verdicts(committed, name):
    mutate, rule = PLAN_TAMPERINGS[name]
    d = copy.deepcopy(_plan(committed))
    mutate(d)
    got = plint.lint_plan_data(copy.deepcopy(d), "tampered.json")
    want = jlint.lint_plan_data(copy.deepcopy(d), "tampered.json")
    assert _records(got) == _records(want)
    assert rule in {v.rule for v in got}


COSTS_TAMPERINGS = {
    "ids_shifted": lambda d: d["per_matching"][0].__setitem__("matching", 7),
    "negative_base": lambda d: d.__setitem__("base_seconds", -1.0),
    "noise_as_fact": lambda d: d["per_matching"][0].update(
        identifiable=False, seconds=0.5),
    "foreign_edge": lambda d: d["per_link"][0].update(u=0, v=5),
    "shares_leak": lambda d: d["per_link"][0].__setitem__("seconds", 9.0),
    "huge_ci": lambda d: d["per_matching"][0].__setitem__("ci95", 1e6),
    "missing_keys": lambda d: d.pop("per_link"),
    "wrong_format": lambda d: d.__setitem__("format",
                                            "matcha_tpu.link_costs/9"),
}


@pytest.mark.parametrize("name", sorted(COSTS_TAMPERINGS))
def test_link_costs_tamperings_give_jax_verdicts(committed, tmp_path, name):
    d = copy.deepcopy(_costs(committed))
    COSTS_TAMPERINGS[name](d)
    got = plint.lint_link_costs_data(copy.deepcopy(d), "costs.json")
    want = jlint.lint_link_costs_data(copy.deepcopy(d), "costs.json")
    assert _records(got) == _records(want)
    assert got
    path = tmp_path / "costs.json"
    path.write_text(json.dumps(d))
    got_file, is_plan = plint.lint_plan_file(path)
    want_file, j_is_plan = jlint.lint_plan_file(path)
    assert is_plan and j_is_plan
    assert _records(got_file) == _records(want_file)


def test_the_tampered_files_scan_alike(committed, tmp_path):
    for name, (mutate, _) in sorted(PLAN_TAMPERINGS.items()):
        d = copy.deepcopy(_plan(committed))
        mutate(d)
        (tmp_path / f"{name}.json").write_text(json.dumps(d))
    (tmp_path / "unreadable.json").write_text("{not json")
    got, files = lint_plan_paths([tmp_path])
    want, jfiles = jlint.lint_plan_paths([tmp_path])
    assert files == jfiles
    assert _records(got) == _records(want)
    assert render_plan_text(got, files) == jlint.render_plan_text(want,
                                                                  jfiles)


def test_non_plan_json_is_ignored_but_a_named_one_is_not(tmp_path):
    other = tmp_path / "not_a_plan.json"
    other.write_text(json.dumps({"cells": [1, 2]}))
    assert lint_plan_paths([tmp_path]) == ([], [])
    got, files = lint_plan_paths([other])
    want, _ = jlint.lint_plan_paths([other])
    assert files == [] and _records(got) == _records(want)
    assert [v.rule for v in got] == ["PL001"]
    assert plint.lint_plan_file(other) == ([], False)
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    got, _ = lint_plan_paths([bad])
    want, _ = jlint.lint_plan_paths([bad])
    assert _records(got) == _records(want)
    assert os.path.basename(got[0].path) == "bad.json"
