"""Deployable binaries (L6): admission controller, background
controller, reports controller, cleanup controller, init job
(reference: cmd/kyverno, cmd/background-controller,
cmd/reports-controller, cmd/cleanup-controller, cmd/kyverno-init)."""
