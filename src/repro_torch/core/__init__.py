"""NormHead, router and the MoE FFN."""
