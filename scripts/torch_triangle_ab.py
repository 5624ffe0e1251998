"""Family-triangle walls of one checkout of the PyTorch port on the GPU.

    python3 scripts/torch_triangle_ab.py CHECKOUT TAG

Sketches ``chip_smoke.py``'s triangle family (64 genomes of 2.3 Mbp, ~1%
from one root, seed 3) and times, after one warm-up call each, 10 calls
of ``engine.batch.triangle`` (2016 pairs: two ``chain_triangle`` groups
of 32 and one 32 x 32 ``chain_block`` tile), 10 of one group's
``chain_triangle`` and 10 of the tile's ``chain_block`` alone, host wall
clock with the card synchronised.  Prints one JSON line ``{"tag",
"triangle", "group", "tile"}`` of seconds per call.

To compare two checkouts (a parent unpacked with ``git archive`` into
``parent/`` and a change into ``change/``) on one card, run pairs in
turns, alternating which side goes first:

    for i in 1 2 3 4 5 6 7 8 9 10; do
      if [ $((i % 2)) -eq 1 ]; then o="parent change"; else o="change parent"; fi
      for s in $o; do python3 scripts/torch_triangle_ab.py $s $s$i; done
    done
"""
import json
import sys
import time

root, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import pyskani_tpu_torch  # noqa: E402
from pyskani_tpu_torch.engine import batch as eb  # noqa: E402
from pyskani_tpu_torch.ops.chain import ChainConfig  # noqa: E402
from pyskani_tpu_torch.ops.sketch import round_up  # noqa: E402

genomes = cs._family_genomes(np.random.default_rng(3), 64, 2_300_000)
names = [f"t{i:02d}" for i in range(64)]
db = pyskani_tpu_torch.Database()
db.sketch_many(zip(names, ([g] for g in genomes)))
sketches = [db._storage.load(n) for n in names]
cfg = ChainConfig()
batch = eb.stack_sketches(sketches)
budgets = eb.default_budgets(sketches, batch, cfg)
dev = batch.device
lo, hi = (eb.take_sketch(batch, torch.arange(a, a + 32, device=dev))
          for a in (0, 32))
app = budgets.max_anchors
calls = {
    "triangle": lambda: eb.triangle(sketches, cfg),
    "group": lambda: eb.chain_triangle(
        lo, cfg=cfg, budgets=budgets,
        total_anchors=round_up(32 * 31 // 2 * app, 8192)),
    "tile": lambda: eb.chain_block(lo, hi, cfg=cfg, budgets=budgets,
                                   total_anchors=round_up(32 * 32 * app,
                                                          8192)),
}
out = {}
for label, fn in calls.items():
    walls = []
    for i in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out[label] = walls[1:]
print(json.dumps({"tag": tag, **out}), flush=True)
