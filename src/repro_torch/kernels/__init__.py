"""Hand-written Hopper kernels (csrc/*.cu) and their plain PyTorch
versions.  Ported: K1 fused_moe_ffn and K2 grouped_matmul_aligned
(grouped_matmul.py), K3/K4 two-pass paged attention (paged_attn.py), K5
fused NormHead logits (normhead.py), K6 the WKV6 recurrence (wkv6.py)."""
