"""k = 15 sketch rates of one checkout of the PyTorch port on the GPU.

    python3 scripts/torch_sketch_ab.py CHECKOUT TAG

Sketches ``chip_smoke.py``'s triangle family (64 genomes of 2.3 Mbp, ~1%
from one root, seed 3) with ``Database.sketch_many`` and with a
per-genome ``Database.sketch`` loop, into a new store each time: one
warm-up call, then 5 timed calls of each, host wall clock with the card
synchronised.  Prints one JSON line ``{"tag", "many", "loop"}`` of Mbp/s.

To compare two checkouts (for example a parent unpacked with
``git archive`` into ``parent/`` and a change into ``change/``) on one
card, run ten pairs in turns, alternating which side goes first:

    for i in 1 2 3 4 5 6 7 8 9 10; do
      if [ $((i % 2)) -eq 1 ]; then o="parent change"; else o="change parent"; fi
      for s in $o; do python3 scripts/torch_sketch_ab.py $s $s$i; done
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

rng = np.random.default_rng(3)
genomes = cs._family_genomes(rng, 64, 2_300_000)
names = [f"t{i:02d}" for i in range(64)]
bp = sum(map(len, genomes))


def many():
    pyskani_tpu_torch.Database().sketch_many(
        zip(names, ([g] for g in genomes)))


def loop():
    db = pyskani_tpu_torch.Database()
    for n, g in zip(names, genomes):
        db.sketch(n, g)


out = {}
for label, fn in (("many", many), ("loop", loop)):
    walls = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out[label] = [bp / 1e6 / w for w in walls[1:]]
print(json.dumps({"tag": tag, **out}), flush=True)
