"""Multi-worker host plan building.

The reference hides rulebook construction behind 10 torch DataLoader
workers (`datasets/scannet.py:448`). This module is the multi-worker
analog: a sliding window of batches whose Topology plans build
concurrently and yield in order.

Workers are THREADS, not processes: forking a process that already runs
JAX's runtime threads can deadlock. Threads scale here because the
planner's hot sections run outside the GIL:
  * the C++ planner (plan_voxelize / plan_neighbor_map / plan_downsample)
    is called through ctypes, which releases the GIL for the call;
  * the NumPy glue (point layout argsort/bincount, array concats)
    releases the GIL inside its large-array ufuncs/sorts.
Whether two plans overlap in practice on the machine with the card has
not been measured.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Optional, Tuple


class PlanPool:
    """Ordered sliding-window plan builder over `workers` threads."""

    def __init__(self, spec, workers: int, use_normals: bool = False,
                 bucket_specs_list=None, window: Optional[int] = None,
                 ns: int = 1):
        self.workers = max(int(workers), 1)
        self.use_normals = use_normals
        self.window = window or self.workers + 2
        self.spec = spec
        self.buckets = bucket_specs_list
        self.ns = ns
        self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                        thread_name_prefix="plan")

    def _build(self, coords, normals) -> Tuple[Optional[object], int]:
        """Build one batch's plan. Runs in a worker thread."""
        from occuseg.native.plan import build_plan_host

        ns = self.ns
        bi = 0
        if self.buckets is not None:
            from occuseg.train.bucketing import plan_for_batch
            bi, plan = plan_for_batch(self.buckets, coords, normals, ns=ns)
        elif ns > 1:
            from occuseg.native.blocked import build_plan_host_blocked
            plan = build_plan_host_blocked(coords, self.spec, ns, normals)
        else:
            plan = build_plan_host(coords, self.spec, normals)
        return plan, bi

    def imap(self, batches: Iterable[Dict]
             ) -> Iterator[Tuple[Dict, Optional[object], int]]:
        """Yield (batch, host_plan, bucket_index) in input order, keeping
        up to `window` plans in flight."""
        pending: deque = deque()
        it = iter(batches)
        exhausted = False
        while True:
            while not exhausted and len(pending) < self.window:
                try:
                    b = next(it)
                except StopIteration:
                    exhausted = True
                    break
                coords = b["coords"]
                normals = b.get("normals") if self.use_normals else None
                pending.append((b, self._pool.submit(self._build, coords,
                                                     normals)))
            if not pending:
                break
            b, fut = pending.popleft()
            plan, bi = fut.result()
            yield b, plan, bi
        # pool stays alive for the next epoch; call close() when done

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
