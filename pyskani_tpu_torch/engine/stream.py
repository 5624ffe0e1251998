"""Out-of-core streamed search: references loaded chunk by chunk.

Port of the JAX package's ``engine/stream.py``.  A disk-backed store
chains a query against its shortlisted references without holding them
all on the device: chunks of ``chunk`` references are loaded by name,
stacked on the host and chained with one ``chain_block`` each.  Peak
device memory is one chunk, whatever the store's size.

On the card a chunk is stacked into pinned host buffers and copied with
``non_blocking=True``.  Loading runs in line: the host's npz decode is
most of a streamed query and ``chain_block`` syncs with the host, so a
worker thread that loads the next chunk while this one chains gained
nothing on an H100 (``chip_smoke.py --overlap``, PERF.md).

With profiling on, each chunk's load is the span ``stream/load``, its
pinned stack and copy ``stream/stage`` and its ``chain_block``
``stream/chain``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import numpy as np
import torch

from ..ops.chain import ChainConfig, EngineBudgets, chain_block
from ..ops.sketch import HostSketch
from ..utils import profiling
from .batch import stack_sketches_host


def stage_chunk(hosts: List[HostSketch], dev, seed_budget: int,
                marker_budget: int, contig_budget: int | None = None):
    """Stack ``hosts`` on the host and copy the stack to ``dev`` as one
    ``DeviceSketch``.  A CUDA target stacks into pinned buffers and copies
    with ``non_blocking=True``; pinned memory belongs to the current
    device's context, so the target card is made current while pinning,
    whichever card the caller has current."""
    dev = torch.device(dev)
    pin = dev.type == "cuda"
    with torch.cuda.device(dev) if pin else contextlib.nullcontext():
        stack = stack_sketches_host(hosts, seed_budget, marker_budget,
                                    contig_budget, pin=pin)
    return stack.map(lambda t: t.to(dev, non_blocking=pin))


def stream_one_vs_many(load: Callable[[str], HostSketch], names: List[str],
                       query, *, cfg: ChainConfig, budgets: EngineBudgets,
                       seed_budget: int, marker_budget: int,
                       contig_budget: int | None = None,
                       chunk: int = 16) -> Dict[str, np.ndarray]:
    """Chain ``query`` (a padded ``DeviceSketch``) against the references
    ``names``, each loaded once by ``load`` (a sketch on the host, as the
    disk storages give with ``device="cpu"``), on the query's device.
    Every chunk has ``chunk`` references: a ragged last chunk is padded
    with its own first reference, as in the JAX package, since the
    chunk's pairs share one anchor pool.  Returns a dict of [len(names)]
    numpy arrays in ``names`` order."""
    if not names:
        return {}
    dev = query.device
    q1 = query.map(lambda x: x[None])
    outs = []
    for i in range(0, len(names), chunk):
        with profiling.scope("stream/load"):
            hosts = [load(n) for n in names[i:i + chunk]]
        hosts += [hosts[0]] * (chunk - len(hosts))
        with profiling.scope("stream/stage"):
            refs = stage_chunk(hosts, dev, seed_budget, marker_budget,
                               contig_budget)
        with profiling.scope("stream/chain", dev):
            out = chain_block(refs, q1, cfg=cfg, budgets=budgets)
        outs.append({k: v[:, 0] for k, v in out.items()})
    P = len(names)
    return {k: torch.cat([o[k] for o in outs])[:P].cpu().numpy()
            for k in outs[0]}
