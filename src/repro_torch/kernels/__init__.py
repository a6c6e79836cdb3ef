"""Hand-written Hopper kernels (csrc/*.cu) and their plain PyTorch
versions.  Ported: K1 fused_moe_ffn (grouped_matmul.py), K3/K4 two-pass
paged attention (paged_attn.py)."""
