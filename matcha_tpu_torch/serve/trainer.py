"""The supervised trainer: one ``train()`` lifetime under the controller.

Port of ``matcha_tpu/serve/trainer.py``.
``python -m matcha_tpu_torch.serve.trainer <spec.json>`` is what the
supervisor (``serve.controller.Controller``) launches: it builds the
``TrainConfig`` from the spec, installs a ``TrainerHarness`` as the
loop's ``boundary_hook``, runs ``train()`` on the spec's ``device``
(``None``: the card; a host without CUDA raises), and maps the harness's
outcome onto the process exit code the supervisor switches on:

* ``0`` — clean completion (ran out of epochs, or a ``stop`` control
  document drained the run);
* ``RESTART_EXIT`` (43) — a *deliberate* restart: the control document
  carried restart-scope fields (``serve.control.RESTART_FIELDS``), the
  harness checkpointed and journaled, and the supervisor should merge
  the fields and relaunch **without charging the crash budget**;
* anything else — a crash, charged against the restart budget.

The harness is the control plane's trainer half.  At every epoch
boundary (the loop's one host seam) it: runs the promotion cadence, then
applies at most one pending control document — value-scope fields in
place through the seam's knob/drift mutators, restart-scope fields via
checkpoint + ``RESTART_EXIT``.  Both halves are idempotent per boundary
(a rollback retry re-enters the same boundary): promotion tracks the
last promoted epoch, control tracks the document's stat signature.
"""

from __future__ import annotations

import json
import sys
from typing import Optional

from .control import RESTART_EXIT, RESTART_FIELDS, VALUE_FIELDS, load_control
from .promote import (
    config_fingerprint,
    consensus_metrics,
    decide_promotion,
    prune_serving,
    snapshot_consensus,
    write_candidate,
)

__all__ = ["RESTART_EXIT", "TrainerHarness", "main"]

_UNSEEN = object()  # control-file signature sentinel: process on first sight


class TrainerHarness:
    """The ``boundary_hook`` a supervised run installs."""

    def __init__(self, spec: dict):
        self.control_path: Optional[str] = spec.get("control_path")
        self.serving_dir: Optional[str] = spec.get("serving_dir")
        self.promote_every = int(spec.get("promote_every") or 0)
        self.promote_margin = float(spec.get("promote_margin") or 0.0)
        self.promote_keep = int(spec.get("promote_keep") or 3)
        self.eval_batch = int(spec.get("eval_batch") or 256)
        self.restart_requested = False
        self._control_sig = _UNSEEN
        self._promoted_epoch = -1
        self._fingerprint: Optional[str] = None

    # ------------------------------------------------------------- the hook
    def on_boundary(self, seam) -> None:
        if self.restart_requested:
            return  # already winding down toward RESTART_EXIT
        self._maybe_promote(seam)
        self._maybe_apply_control(seam)

    # ---------------------------------------------------------- promotions
    def _maybe_promote(self, seam) -> None:
        every = self.promote_every
        if not every or not self.serving_dir or seam.epoch == 0:
            return
        if seam.epoch % every or seam.epoch == self._promoted_epoch:
            return
        self._promoted_epoch = seam.epoch  # idempotent under rollback retry
        if self._fingerprint is None:
            self._fingerprint = config_fingerprint(seam.config)
        arrays = snapshot_consensus(seam.state, seam.flattener)
        metrics = consensus_metrics(seam.state, seam.x_test, seam.y_test,
                                    batch=self.eval_batch)
        candidate = write_candidate(
            self.serving_dir, seam.epoch,
            # host arithmetic, NOT a device read of state.step — the
            # promotion cadence adds zero per-step syncs
            step=seam.epoch * seam.bpe,
            arrays=arrays, metrics=metrics,
            fingerprint=self._fingerprint,
            journal_offset=len(seam.recorder.events))
        action, serving = decide_promotion(
            self.serving_dir, candidate, margin=self.promote_margin)
        prune_serving(self.serving_dir, keep=self.promote_keep)
        seam.recorder.log_event(
            "promotion", action=action, epoch=seam.epoch,
            metric=metrics["test_acc"], test_loss=metrics["test_loss"],
            serving_epoch=int(serving["epoch"]),
            content_hash=candidate["content_hash"][:16])

    # ------------------------------------------------------- control plane
    def _maybe_apply_control(self, seam) -> None:
        path = self.control_path
        if not path:
            return
        sig = self._stat_sig(path)
        if sig == self._control_sig:
            return  # unchanged since last look (or rollback-retry re-entry)
        self._control_sig = sig
        raw, problems = load_control(path)
        if raw is None:
            return  # no document yet
        version = raw.get("version")
        if problems:
            # rejected WHOLE: no field applies, the run continues, and
            # the decision is on the record with every reason
            seam.recorder.log_event(
                "control", action="reject", applied=False,
                reason="; ".join(problems), epoch=seam.epoch,
                version=version if isinstance(version, int) else None)
            return
        if raw.get("stop"):
            seam.checkpoint()
            seam.recorder.log_event(
                "control", action="stop", applied=True,
                reason="operator stop document", epoch=seam.epoch,
                version=version)
            seam.request_stop()
            return
        # cross-field validation against the RUNNING config, before any
        # field applies — schema validation (load_control) cannot know
        # that e.g. staleness > 1 needs overlap='1step'.  One bad combo
        # rejects the document whole: applying the value-scope half and
        # then crash-looping on the restart half would be exactly the
        # half-applied state the contract forbids (and would burn the
        # supervisor's crash budget on an operator typo).
        import dataclasses

        config_fields = {k: raw[k] for k in (*VALUE_FIELDS, *RESTART_FIELDS)
                         if k in raw}
        try:
            dataclasses.replace(seam.config, **config_fields)
        except (ValueError, TypeError) as e:
            seam.recorder.log_event(
                "control", action="reject", applied=False,
                reason=f"invalid against the running config: {e}",
                epoch=seam.epoch, version=version)
            return
        values = {k: raw[k] for k in VALUE_FIELDS if k in raw}
        # restart-scope fields that actually DIFFER from the running
        # config: after the supervisor merges and relaunches, the same
        # document re-reads as a no-op — no restart loop
        restart = {k: raw[k] for k in RESTART_FIELDS
                   if k in raw and getattr(seam.config, k) != raw[k]}
        if values:
            detail, predicted = self._apply_values(seam, values)
            # chaos barrier (a no-op unless armed): dying here — values
            # applied in memory, the decision not yet journaled — is the
            # worst mid-swap state; recovery must re-apply the document
            # idempotently, never observe it half-applied
            from ..chaos.taps import maybe_kill

            maybe_kill("mid_control")
            seam.recorder.log_event(
                "control", action="apply", applied=True,
                reason=f"value-scope fields {sorted(values)}",
                epoch=seam.epoch, version=version, fields=detail,
                # the re-based prediction rides the event so the drift
                # replay (`obs_torch.py drift`) re-bases at this epoch too —
                # the same parity rule alpha_rederived/membership follow
                **({"predicted": predicted}
                   if isinstance(predicted, dict) else {}))
        if restart:
            seam.checkpoint()
            seam.recorder.log_event(
                "control", action="restart", applied=True,
                reason=f"restart-scope fields {sorted(restart)} need a "
                       f"relaunch (state shapes / controller state)",
                epoch=seam.epoch, version=version, fields=restart)
            self.restart_requested = True
            seam.request_stop()

    def _apply_values(self, seam, values: dict):
        """Apply value-scope fields through the seam — knob and drift
        updates only, so the step is not rebuilt.
        Returns ``(detail, predicted)``: what applied, and the re-based
        drift prediction the journal event carries for replay parity."""
        detail = {}
        predicted = None
        if "budget" in values:
            from ..plan import resolve_budget_swap

            swap = resolve_budget_swap(seam.schedule,
                                       float(values["budget"]))
            seam.set_control(row_scale=swap["row_scale"],
                             alpha_scale=swap["alpha_scale"])
            seam.update_config(budget=float(values["budget"]))
            predicted = seam.rebase_drift(alpha=swap["alpha"],
                                          probs=swap["probs"])
            detail["budget"] = {
                "budget": swap["budget"], "alpha": swap["alpha"],
                "rho": swap["rho"], "alpha_scale": swap["alpha_scale"],
                "unreachable": swap["unreachable"],
                "row_scale": [float(v) for v in swap["row_scale"]]}
        if "local_steps" in values:
            ls = int(values["local_steps"])
            seam.set_control(local_every=ls)
            seam.update_config(local_steps=ls)
            predicted = seam.rebase_drift()
            detail["local_steps"] = ls
        drift = {k: values[k] for k in ("drift_tolerance", "drift_patience")
                 if k in values}
        if drift:
            seam.update_config(**drift)
            predicted = seam.rebase_drift()
            detail.update(drift)
        return detail, predicted

    @staticmethod
    def _stat_sig(path: str):
        import os

        try:
            st = os.stat(path)
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m matcha_tpu_torch.serve.trainer",
        description="one supervised train() lifetime (launched by the "
                    "serve controller; see serve_torch.py for the daemon)")
    parser.add_argument("spec", help="path to the controller's spec JSON")
    args = parser.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)

    from ..train import TrainConfig, train

    config = TrainConfig(**spec["config"])
    harness = TrainerHarness(spec)
    train(config, device=spec.get("device"),
          boundary_hook=harness.on_boundary)
    return RESTART_EXIT if harness.restart_requested else 0


if __name__ == "__main__":
    sys.exit(main())
