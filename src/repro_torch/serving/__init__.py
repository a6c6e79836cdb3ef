"""Online continuous-batching serving over a paged device KV cache."""
