"""Run one function on W local CPU processes joined in a gloo group (the
CPU's data parallelism: the multi-rank tests and cli/dryrun_multichip.py).

    results = spawn("package.module:function", world=2, workdir=d, kwargs={...})

Each rank is a fresh `python -m wseg_tpu_torch.parallel.launch` process that
joins the group over a `file://` store in `workdir` (no TCP port), calls
`function(group, **kwargs)` and saves what it returns; `spawn` returns the
ranks' results in rank order. Every wait is bounded: the group's collective
timeout and the parent's join both come from `timeout`, and a rank that
fails or outlives it ends the whole spawn with its log's tail.

With `torchrun=True` the ranks start as torchrun starts them: they join no
group, each gets torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT), and `function(None, **kwargs)` joins through
parallel/mesh.py:init_from_env itself, as the CLIs do. As torchrun's agent
does, the parent hosts the rendezvous store (TORCHELASTIC_USE_AGENT_STORE),
on a port that the kernel picks, so spawns that run at once never share
one; the parent's join bounds the wait.
"""

from __future__ import annotations

import datetime
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parents[2]


def _paths(workdir: Path, rank: int) -> tuple[Path, Path]:
    return workdir / f"rank{rank}.log", workdir / f"rank{rank}.pt"


def spawn(target: str, world: int, workdir: str | os.PathLike, kwargs: dict | None = None,
          timeout: float = 300.0, pythonpath=(), torchrun: bool = False) -> list:
    """Run `target` ("module:function") on `world` gloo CPU ranks and return
    their results; `pythonpath`: extra import roots for the ranks;
    `torchrun`: the ranks join through torchrun's environment. Each rank
    runs a quarter of its share of the host's cores as torch threads:
    threads that outnumber the cores spin, and the ranks share the host
    with their caller and, under a test runner, with other workers."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    if (workdir / "store").exists():
        raise FileExistsError(f"{workdir / 'store'}: a spawn needs a fresh store")
    torch.save(kwargs or {}, workdir / "kwargs.pt")
    threads = max(1, (os.cpu_count() or 1) // (4 * world))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), *map(str, pythonpath), os.environ.get("PYTHONPATH", "")]))
    store = None
    if torchrun:
        store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False,
                              timeout=datetime.timedelta(seconds=timeout))
        env.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(store.port), TORCHELASTIC_USE_AGENT_STORE="True")
    procs = []
    try:
        for rank in range(world):
            rank_env = dict(env, RANK=str(rank), LOCAL_RANK=str(rank)) if torchrun else env
            with open(_paths(workdir, rank)[0], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "wseg_tpu_torch.parallel.launch", target, str(rank),
                     str(world), str(workdir), str(timeout), str(threads), str(int(torchrun))],
                    cwd=REPO, env=rank_env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout + 30  # the ranks' own timeout fires first
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                what = f"rank {failed[0]} failed" if failed else f"timed out after {timeout} s"
                raise RuntimeError(f"spawn {target} x {world}: {what}\n"
                                   + _tail(workdir, failed[0] if failed else 0))
            time.sleep(0.05)
        for rank, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"spawn {target} x {world}: rank {rank} exited "
                                   f"{p.returncode}\n" + _tail(workdir, rank))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
    return [torch.load(_paths(workdir, r)[1], weights_only=False) for r in range(world)]


def _tail(workdir: Path, rank: int, n: int = 4000) -> str:
    return _paths(workdir, rank)[0].read_text()[-n:]


def _rank_main(target: str, rank: int, world: int, workdir: Path, timeout: float,
               threads: int, torchrun: bool):
    torch.set_num_threads(threads)
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    kwargs = torch.load(workdir / "kwargs.pt", weights_only=False)
    if torchrun:  # the target joins the group itself
        torch.save(fn(None, **kwargs), _paths(workdir, rank)[1])
        return
    dist.init_process_group("gloo", init_method=(workdir / "store").as_uri(), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        torch.save(fn(dist.group.WORLD, **kwargs), _paths(workdir, rank)[1])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    t, r, w, d, to, th, tr = sys.argv[1:8]
    _rank_main(t, int(r), int(w), Path(d), float(to), int(th), bool(int(tr)))
