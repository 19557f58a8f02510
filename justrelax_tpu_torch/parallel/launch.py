"""Start a world of rank processes on one machine.

    python -m justrelax_tpu_torch.parallel.launch MODULE:FUNCTION OUT [ARG ...] \
        [--device cpu|cuda] [--backend gloo|nccl] [--timeout S]

runs one rank: it joins the process group (:func:`multihost.initialize`,
from torchrun's variables), calls ``FUNCTION(*ARGS)`` of
``MODULE`` and, on rank 0, writes what it returns to ``OUT`` (a pickle).
``torchrun --nproc-per-node=N -m justrelax_tpu_torch.parallel.launch ...``
runs N of them; :class:`World` starts them as subprocesses with a free
port and waits for them within a time limit. Without ``--device`` each
rank runs on the card and raises without one, as every entry point of the
port does; ``--device cpu`` puts its tiles on the CPU (gloo).
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch

from justrelax_tpu_torch.parallel import multihost

# the directory that holds the package: on every rank's import path
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("target", help="MODULE:FUNCTION")
    ap.add_argument("out")
    ap.add_argument("args", nargs="*")
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--timeout", type=float, default=120.0)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    module, name = a.target.split(":")
    fn = getattr(importlib.import_module(module), name)
    multihost.initialize(backend=a.backend, device=a.device, timeout=a.timeout)
    try:
        out = fn(*a.args)
        if multihost.process_index() == 0:
            with open(a.out, "wb") as f:
                pickle.dump(out, f)
    finally:
        multihost.shutdown()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``nranks`` rank processes running ``target`` (``MODULE:FUNCTION``)
    with ``args``, ``hosts`` hosts of ``nranks // hosts`` ranks told apart
    by ``LOCAL_RANK`` and ``GROUP_RANK``, started at once. ``device=None``
    puts every rank on the card. :meth:`result` waits for all of them
    within ``timeout`` seconds and returns rank 0's result; a rank that
    fails or outlives the limit fails the world, and no process is left
    running. ``rank_timeout`` bounds each collective of a rank."""

    def __init__(self, target: str, nranks: int = 4, args: Sequence[str] = (),
                 device: Optional[str] = None, backend: Optional[str] = None, hosts: int = 1,
                 timeout: float = 600.0, rank_timeout: float = 120.0):
        self.target, self.nranks, self.timeout = target, nranks, timeout
        self._tmp = tempfile.TemporaryDirectory(prefix="jr_world_")
        self.out = os.path.join(self._tmp.name, "out.pkl")
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        per_host = nranks // hosts
        env.update(OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                   WORLD_SIZE=str(nranks), LOCAL_WORLD_SIZE=str(per_host))
        cmd = [sys.executable, "-m", "justrelax_tpu_torch.parallel.launch", target, self.out,
               *map(str, args), "--timeout", str(rank_timeout)]
        for flag, value in (("--device", device), ("--backend", backend)):
            if value is not None:
                cmd += [flag, str(value)]
        self.procs, self.logs = [], []
        self.started = time.monotonic()
        try:
            for r in range(nranks):
                e = dict(env, RANK=str(r), LOCAL_RANK=str(r % per_host),
                         GROUP_RANK=str(r // per_host))
                log = open(os.path.join(self._tmp.name, f"rank{r}.log"), "w+")
                self.logs.append(log)
                self.procs.append(subprocess.Popen(cmd, cwd=ROOT, env=e, stdout=log,
                                                   stderr=subprocess.STDOUT))
        except BaseException:
            self.stop()
            raise

    def stop(self) -> str:
        """Kill what still runs; the ranks' logs (their tails)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        text = []
        for r, log in enumerate(self.logs):
            if not log.closed:
                log.seek(0)
                text.append(f"--- rank {r} (exit {self.procs[r].returncode}):\n"
                            + log.read()[-4000:])
                log.close()
        return "\n".join(text)

    def result(self):
        try:
            deadline = self.started + self.timeout
            for p in self.procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            logs = self.stop()
        try:
            if any(p.returncode != 0 for p in self.procs) or not os.path.exists(self.out):
                raise RuntimeError(f"the world of {self.nranks} ranks running {self.target!r} "
                                   f"failed:\n{logs}")
            with open(self.out, "rb") as f:
                return pickle.load(f)
        finally:
            self._tmp.cleanup()


if __name__ == "__main__":
    _main()
