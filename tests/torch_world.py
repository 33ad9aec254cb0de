"""A persistent world of CPU ranks for the port's mesh tests.

``World(n)`` starts ``n`` processes that join one gloo process group
(``repro_torch.launch.mesh.init_world``, a ``file://`` rendezvous, so
parallel test workers never share a port) and then run the jobs they are
sent: ``world.run(fn, *args)`` calls ``fn(rank, world_size, *args)`` on every
rank and returns the ranks' results in rank order, raising with every
failing rank's traceback.  ``fn`` must be importable (a module-level
function).  One world serves a whole test module (a module fixture), so
the spawn and the imports are paid once.
"""

import os
import queue
import tempfile
import traceback

import torch
import torch.multiprocessing as mp


def _worker(rank, n, init_method, inq, outq):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world
    init_world(None, rank, n, init_method, device_type="cpu", timeout_s=120)
    while True:
        job = inq.get()
        if job is None:
            break
        fn, args = job
        try:
            outq.put((rank, True, fn(rank, n, *args)))
        except BaseException:
            outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    def __init__(self, n: int = 4):
        ctx = mp.get_context("spawn")
        fd, path = tempfile.mkstemp(prefix="repro_torch_world_")
        os.close(fd)
        os.unlink(path)
        self.n = n
        self._inqs = [ctx.Queue() for _ in range(n)]
        self._outq = ctx.Queue()
        self._procs = [ctx.Process(target=_worker, daemon=True,
                                   args=(r, n, f"file://{path}", self._inqs[r], self._outq))
                       for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, timeout: float = 300.0) -> list:
        for q in self._inqs:
            q.put((fn, args))
        results, errors = {}, []
        for _ in range(self.n):
            try:
                rank, ok, val = self._outq.get(timeout=timeout)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"{fn.__name__}: the ranks did not answer in {timeout} s")
            if ok:
                results[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
        if errors:
            raise AssertionError(f"{fn.__name__} failed\n" + "\n".join(errors))
        return [results[r] for r in range(self.n)]

    def close(self):
        for q, p in zip(self._inqs, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
