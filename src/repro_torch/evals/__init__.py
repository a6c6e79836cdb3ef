"""Evaluation harness (own copy of `repro.evals`)."""
