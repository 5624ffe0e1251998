"""Worker process for the port's multi-process test (test_torch_multihost.py).

Usage: python torch_multihost_worker.py <coordinator> <num_processes> <process_id>

Each process is one rank on the CPU (gloo): it joins the world through
``pyskani_tpu_torch.parallel.dist.initialize_multihost`` (TCP rendezvous
at the coordinator; a 1-process run joins none), sketches the same
deterministic genomes, runs one sharded search step on the default mesh
(db = world size) and prints the mesh-wide stats.  Imports only the port.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from pyskani_tpu_torch.engine.batch import stack_sketches
from pyskani_tpu_torch.ops.chain import ChainConfig, EngineBudgets
from pyskani_tpu_torch.ops.sketch import sketch_genome_device
from pyskani_tpu_torch.parallel.dist import (initialize_multihost,
                                             make_sharded_search,
                                             shard_leading)
from pyskani_tpu_torch.parallel.mesh import make_mesh
from pyskani_tpu_torch.params import SketchParams


def family(n, seed=0, length=4000):
    """The JAX multihost worker's genomes (tests/multihost_worker.py)."""
    rng = np.random.default_rng(1234)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=length)
    rng = np.random.default_rng(seed)
    params = SketchParams()
    out = []
    for i in range(n):
        arr = base.copy()
        idx = rng.integers(0, length, length // 50)
        arr[idx] = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                              size=len(idx))
        out.append(sketch_genome_device(
            f"g{i}", [arr.tobytes()], params, seed_budget=1024,
            marker_budget=512, length_bucket=1 << 13, max_contigs=8,
            device="cpu"))
    return out


def main():
    coordinator, num_processes, process_id = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    torch.set_num_threads(1)
    if num_processes > 1:
        initialize_multihost(coordinator=coordinator,
                             num_processes=num_processes,
                             process_id=process_id, device="cpu")
    mesh = make_mesh(device="cpu")
    assert mesh.size == num_processes and mesh.rank == process_id
    refs = stack_sketches(family(4, seed=1))
    queries = stack_sketches(family(4, seed=2))
    budgets = EngineBudgets(max_anchors=2048, max_fragments=64,
                            max_anchors_per_fragment=128)
    step = make_sharded_search(mesh, ChainConfig(), budgets, chunk=2)
    out = step(shard_leading(mesh, refs, "db"),
               shard_leading(mesh, queries, "batch"))
    print(f"RESULT process={process_id} "
          f"total_hits={int(out['total_hits'][0])} "
          f"n_chained={int(out['n_chained'][0])} "
          f"ani_sum={float(out['ani_mean'].double().sum()):.6f}", flush=True)
    if num_processes > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
