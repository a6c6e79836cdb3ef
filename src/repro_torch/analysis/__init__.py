"""The engines' debug sync guards (own copy of the part of
`repro.analysis` that PyTorch has a use for)."""
