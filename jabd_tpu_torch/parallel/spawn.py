"""Run a function on N ranks of a fresh process group, one process each.

The caller's launcher when torchrun is not at hand (tests, `chip_smoke.py`,
a notebook): `run("pkg.module:function", world, payload, workdir)` starts
`world` interpreters of this module, each joins the group through a
`file://` rendezvous in `workdir` (no TCP port to collide on), loads
`payload` (`torch.save`d to `workdir`), calls `function(payload, mesh)`
with the process mesh on `device` and saves what it returns. The parent
waits for every rank and returns their results in rank order; a rank that
fails or outlives `timeout` fails the call with its output, and every
child is stopped.

    python -m jabd_tpu_torch.parallel.spawn <target> <rank> <world> <workdir> <backend> <device> <threads>

The children never import JAX: XLA_FLAGS and JAX_PLATFORMS are dropped
from their environment.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
from typing import Any, List, Optional

import torch


def run(
    target: str,
    world: int,
    payload: Any,
    workdir: str,
    backend: str = "gloo",
    device: str = "cpu",
    threads: int = 1,
    timeout: float = 600.0,
    cwd: Optional[str] = None,
) -> List[Any]:
    """`target` ("module:function") on ranks 0..world-1; returns each
    rank's return value. `device` is every rank's device ("cpu", "cuda:0")
    or "rank" for cuda:<rank>; `threads` pins torch's CPU threads."""
    os.makedirs(workdir, exist_ok=True)
    for stale in ["rendezvous"] + [f"result{r}.pt" for r in range(world)]:
        if os.path.exists(os.path.join(workdir, stale)):
            os.remove(os.path.join(workdir, stale))
    torch.save(payload, os.path.join(workdir, "payload.pt"))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = str(threads)
    cwd = cwd or os.getcwd()
    env["PYTHONPATH"] = os.pathsep.join(p for p in (cwd, env.get("PYTHONPATH", "")) if p)
    procs = []
    logs = []
    try:
        for rank in range(world):
            log = open(os.path.join(workdir, f"rank{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "jabd_tpu_torch.parallel.spawn", target, str(rank), str(world),
                 workdir, backend, device, str(threads)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=cwd,
            ))
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                failed = "timed out"
                break
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}" if bad else None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for log in logs:
        log.seek(0)
        out.append(log.read())
        log.close()
    if failed:
        raise RuntimeError(f"{target} on {world} ranks: {failed}\n" + "\n".join(
            f"--- rank {r} ---\n{text[-4000:]}" for r, text in enumerate(out)))
    results = [torch.load(os.path.join(workdir, f"result{r}.pt"), weights_only=False) for r in range(world)]
    for r, text in enumerate(out):
        if text.strip():
            print(f"[rank {r}] " + text.rstrip().replace("\n", f"\n[rank {r}] "))
    return results


def _child(target: str, rank: int, world: int, workdir: str, backend: str, device: str, threads: int) -> None:
    import faulthandler

    from jabd_tpu_torch.parallel import mesh as M

    faulthandler.enable()  # a crash in a collective shows its Python stack
    torch.set_num_threads(threads)
    dev = torch.device(f"cuda:{rank}" if device == "rank" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    M.init_distributed(f"file://{os.path.join(workdir, 'rendezvous')}", world, rank, backend=backend)
    try:
        payload = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(payload, M.process_mesh(dev))
        tmp = os.path.join(workdir, f"result{rank}.pt.tmp")
        torch.save(result, tmp)
        os.replace(tmp, os.path.join(workdir, f"result{rank}.pt"))
        M.barrier(M.process_mesh(dev))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    t, r, w, d, b, dev, th = sys.argv[1:8]
    _child(t, int(r), int(w), d, b, dev, int(th))
