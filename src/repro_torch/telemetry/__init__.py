"""Metrics registry and the XPUTimer span tracer."""
