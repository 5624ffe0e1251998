"""Config honesty on the port, as ``tests/test_config_parity.py`` holds it
for the JAX package: every ``ChainConfig`` that ``_check_supported``
accepts gives the same results on the per-pair (``chain_pairs``) and the
packed block (``chain_block``) pipelines, and every rejected config
raises ``NotImplementedError`` up front on ``chain_block``,
``chain_pairs`` and ``chain_triangle``."""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import mutate, random_genome
from pyskani_tpu_torch.engine.batch import stack_sketches, take_sketch
from pyskani_tpu_torch.ops.chain import (ChainConfig, EngineBudgets,
                                         chain_block, chain_pairs,
                                         chain_triangle)
from pyskani_tpu_torch.ops.sketch import sketch_genome_device
from pyskani_tpu_torch.params import SketchParams

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair_batch():
    rng = np.random.default_rng(11)
    base = random_genome(rng, 400_000)
    sketches = [
        sketch_genome_device("a", [base], SketchParams(), device="cpu"),
        sketch_genome_device("b", [mutate(rng, base, 0.03)], SketchParams(),
                             device="cpu"),
    ]
    return stack_sketches(sketches)


# the accepted surface of _check_supported, axis by axis
ACCEPTED_VARIANTS = [
    {},
    {"chain_group_side": "query"},
    {"est_side": "chunk"},
    {"est_ci": True},
    {"mask_repetitive_denom": "none"},
]

REJECTED = [
    {"denom_mode": "fragment"},
    {"denom_mode": "length"},
    {"nonoverlap_side": "ref"},
    {"sort_by": "query"},
    {"numer_mode": "distinct"},
    {"chain_scope": "global"},
    {"span_source": "all"},
    {"est_side": "other"},
    {"min_span_cover": 0.5},
]

BUDGETS = EngineBudgets(max_fragments=128, max_anchors_per_fragment=256)


def _pair(batch):
    return (take_sketch(batch, torch.tensor([0])),
            take_sketch(batch, torch.tensor([1])))


@pytest.mark.parametrize("overrides", ACCEPTED_VARIANTS,
                         ids=[str(sorted(v)) for v in ACCEPTED_VARIANTS])
def test_accepted_config_block_equals_pairs(pair_batch, overrides):
    cfg = dataclasses.replace(ChainConfig(), **overrides)
    r, q = _pair(pair_batch)
    pp = chain_pairs(r, q, cfg=cfg, budgets=BUDGETS)
    bb = chain_block(r, q, cfg=cfg, budgets=BUDGETS)
    keys = ["ani_mean", "ani_robust", "ani_median", "af_query", "af_ref",
            "n_fragments"]
    if cfg.est_ci:
        keys += ["ani_ci_low", "ani_ci_high"]
    for key in keys:
        np.testing.assert_allclose(
            pp[key][0].numpy(), bb[key][0, 0].numpy(),
            rtol=0, atol=1e-6, err_msg=f"{key} for {overrides}")
    assert 0.95 < float(pp["ani_mean"][0]) < 0.99


@pytest.mark.parametrize("overrides", REJECTED,
                         ids=[str(sorted(v.items())) for v in REJECTED])
def test_rejected_config_raises_on_every_path(pair_batch, overrides):
    cfg = dataclasses.replace(ChainConfig(), **overrides)
    r, q = _pair(pair_batch)
    with pytest.raises(NotImplementedError):
        chain_pairs(r, q, cfg=cfg, budgets=BUDGETS)
    with pytest.raises(NotImplementedError):
        chain_block(r, q, cfg=cfg, budgets=BUDGETS)
    with pytest.raises(NotImplementedError):
        chain_triangle(pair_batch, cfg=cfg, budgets=BUDGETS)
