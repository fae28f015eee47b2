"""Ranks for the port's multi-process tests: gloo processes on a free
localhost port, as tests/test_torch_train_ddp.py starts them.

``spawn(module, world, out_dir)`` starts ``world`` processes, each of which
imports ``module`` (a file in tests/ that imports no JAX) and calls its
``ranked(rank, out_dir)`` inside an initialised process group; the test
then reads what each rank wrote under ``out_dir``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(module: str, world: int, out_dir: str, timeout: float = 400) -> None:
    """Run ``module.ranked(rank, out_dir)`` in ``world`` gloo ranks; raises
    with their logs when one fails."""
    code = (f"import sys; sys.path.insert(0, {TESTS_DIR!r}); "
            "import _torch_ranks; _torch_ranks.main(sys.argv[1], int(sys.argv[2]), "
            "int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])")
    port = free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, module, str(r), str(world),
                               str(port), out_dir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("\n".join(f"rank {r} rc {p.returncode}:\n{log[-4000:]}"
                                       for r, (p, log) in enumerate(zip(procs, logs))))


def main(module: str, rank: int, world: int, port: int, out_dir: str) -> None:
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        importlib.import_module(module).ranked(rank, out_dir)
    finally:
        dist.destroy_process_group()
