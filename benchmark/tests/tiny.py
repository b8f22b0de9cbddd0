"""Tiny cells for the CPU tests: the real cells' files with the widths cut
so that a run fits a test (the program takes its plain PyTorch versions on
the CPU)."""

from __future__ import annotations

import copy

from benchmark.harness import spec

MODEL = dict(dim=64, depth=2, heads=2, dim_head=16)
VOCODER = dict(upsample_initial_channel=32, upsample_rates=[8, 5, 4, 3],
               upsample_kernel_sizes=[16, 10, 8, 6], resblock_kernel_sizes=[3],
               resblock_dilation_sizes=[[1, 3]])


def cell(name: str, **traffic) -> spec.Cell:
    """The cell ``name`` of BENCHMARK.json at tiny widths; ``traffic``
    overrides keys of its mix."""
    c = spec.load_cell(name)
    c.config = copy.deepcopy(c.config)
    for group, widths in (("model", MODEL), ("vocoder", VOCODER)):
        if group in c.config:
            c.config[group].update(widths)
    c.traffic = {**copy.deepcopy(c.traffic), **traffic}
    return c
