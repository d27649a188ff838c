"""Async controllers (L5): webhook configuration reconciler, cert
manager, cleanup, leader election (reference: pkg/controllers)."""
