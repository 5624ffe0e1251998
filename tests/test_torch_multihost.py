"""Port's multi-process start-up: 2 ranks over a TCP coordinator.

Two ``torch_multihost_worker.py`` processes join one gloo world through
``initialize_multihost`` on a free port and run a sharded search step;
their RESULT lines must agree, equal a 1-process run's, and equal the JAX
package's ``make_sharded_search`` on the same genomes.  The ranks that
``dist.launch`` spawns report a failed rank's traceback, and a world that
outlives its timeout is stopped.
"""

import os
import re
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from pyskani_tpu.engine.batch import stack_sketches
from pyskani_tpu.oracle.chain import ChainConfig
from pyskani_tpu.ops.chain import EngineBudgets
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.parallel.dist import make_sharded_search, shard_leading
from pyskani_tpu.parallel.mesh import make_mesh
from pyskani_tpu.params import SketchParams
from pyskani_tpu_torch.parallel import dist as tdist

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multihost_worker.py")
PATTERN = (r"RESULT process=(\d+) total_hits=(\d+) n_chained=(\d+) "
           r"ani_sum=([0-9.]+)")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _result(out: str):
    m = re.search(PATTERN, out)
    assert m, f"no RESULT line in: {out[-1000:]}"
    return int(m.group(1)), (int(m.group(2)), int(m.group(3)),
                             float(m.group(4)))


def _jax_result():
    """The JAX package's step on the workers' genomes (the JAX multihost
    worker's family), on a 2 x 2 mesh."""
    def family(n, seed):
        rng = np.random.default_rng(1234)
        base = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=4000)
        rng = np.random.default_rng(seed)
        out = []
        for i in range(n):
            arr = base.copy()
            idx = rng.integers(0, 4000, 4000 // 50)
            arr[idx] = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                  size=len(idx))
            out.append(sketch_genome_device(
                f"g{i}", [arr.tobytes()], SketchParams(), seed_budget=1024,
                marker_budget=512, length_bucket=1 << 13, max_contigs=8))
        return out
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    step = make_sharded_search(mesh, ChainConfig(), EngineBudgets(
        max_anchors=2048, max_fragments=64, max_anchors_per_fragment=128),
        chunk=2)
    out = jax.device_get(step(
        shard_leading(mesh, stack_sketches(family(4, 1)), "db"),
        shard_leading(mesh, stack_sketches(family(4, 2)), "batch")))
    return (int(out["total_hits"][0]), int(out["n_chained"][0]),
            float(np.asarray(out["ani_mean"], np.float64).sum()))


def test_two_process_initialize_multihost():
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coord, "2", str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, f"worker failed: {err[-3000:]}"
            pid, res = _result(out)
            results[pid] = res
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert results[0] == results[1], "processes disagree"

    ref = subprocess.run([sys.executable, WORKER, "", "1", "0"],
                         capture_output=True, text=True, timeout=180)
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert _result(ref.stdout) == (0, results[0])

    hits, chained, ani_sum = _jax_result()
    assert (hits, chained) == results[0][:2]
    assert abs(ani_sum - results[0][2]) < 1e-4


def test_launch_reports_a_failed_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank failed on purpose"):
        tdist.launch(worker.fail, 2, device="cpu", timeout=120)
    assert time.monotonic() - t0 < 60


def test_launch_stops_a_world_past_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish in 3"):
        tdist.launch(worker.sleep, 2, device="cpu", timeout=3)
    assert time.monotonic() - t0 < 60


def test_launch_needs_a_card_per_rank_on_cuda():
    with pytest.raises(RuntimeError, match="4096 ranks need 4096 CUDA"):
        tdist.launch(worker.fail, 4096, device="cuda")


def test_workers_import_only_the_port():
    """The spawned ranks and worker processes never import JAX."""
    code = ("import sys; import torch_mesh_worker; "
            "sys.argv = ['w', '', '1', '0']; import torch_multihost_worker; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pyskani_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE, os.path.dirname(HERE)]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
