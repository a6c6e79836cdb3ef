"""The synthetic pre-training data pipeline."""
