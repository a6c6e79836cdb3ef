"""High-level runner for the port (counterpart of `repro.api.Runner`,
serving half at tp=1): parameter init, paged KV pools, and the paged
serving steps as plain callables.

Entry points run on the card: `device` defaults to "cuda", and asking
for it without one raises.  Pass device="cpu" for the plain PyTorch path
(every kernel wrapper then takes its plain version).  The runner turns
TF32 off for CUDA matmuls (`torch.backends.cuda.matmul.allow_tf32 =
False`, PyTorch's default): the fp32 products the port leaves to
`torch.matmul` — the router and the NormHead — stay full fp32, as in
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    return device


@dataclasses.dataclass
class Runner:
    cfg: ModelConfig
    flags: M.RunFlags = M.DEFAULT_FLAGS
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        M.check_paged_support(self.cfg)
        torch.backends.cuda.matmul.allow_tf32 = False

    def init_params(self, seed: int = 0):
        """Random parameters on the runner's device from
        `torch.Generator(device).manual_seed(seed)`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return M.init_model(self.cfg, device=self.device, generator=gen)

    def init_paged_pools(self, n_pages: int, page_size: int):
        """Zeroed paged KV pools; page 0 is the scratch page.  Also where
        `flags.paged_attn` is validated, before any step runs."""
        L.resolve_paged_attn(self.flags.paged_attn)
        return M.init_paged_caches(self.cfg, n_pages, page_size, self.device)

    def make_paged_decode_step(self, page_size: int):
        """Greedy paged decode tick: ``(params, pools, token (B,), pos
        (B,), table (B, n_lp), active (B,)) -> (next (B,), pools)``; pools
        update in place."""
        cfg, flags = self.cfg, self.flags

        @torch.no_grad()
        def step(params, pools, token, pos, table, active):
            return M.paged_decode_step(cfg, params, pools, token, pos, table,
                                       active, page_size=page_size,
                                       flags=flags)
        return step

    def make_paged_prefill(self, page_size: int):
        """Greedy chunked-prefill step: ``(params, pools, tokens (C,),
        base, n_valid, table_row (n_lp,)) -> (next token, pools)``; pools
        update in place."""
        cfg, flags = self.cfg, self.flags

        @torch.no_grad()
        def step(params, pools, tokens, base, n_valid, table_row):
            return M.paged_prefill_chunk(cfg, params, pools, tokens, base,
                                         n_valid, table_row,
                                         page_size=page_size, flags=flags)
        return step

