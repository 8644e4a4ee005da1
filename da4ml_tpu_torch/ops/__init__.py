"""Scalar op semantics shared by IR replay and the tracer."""
