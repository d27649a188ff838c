"""Conformance harnesses replaying the reference's test corpora."""
