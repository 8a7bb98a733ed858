"""Straggler mitigation: a deadline miss is a fail-stop (paper Sec. I;
port of :mod:`repro.train.straggler`).

The paper motivates fail-stop recovery with cores that "do not return the
results within a predetermined deadline". :class:`DeadlineExecutor` runs
per-stream host callables under a wall-clock deadline; a miss marks that
stream failed and the caller rolls FORWARD by disentangling the other M-1
streams: no waiting and no recomputation.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import time
from typing import Callable, Optional, Sequence


@dataclasses.dataclass
class StreamResult:
    index: int
    value: object = None
    failed: bool = False
    elapsed_s: float = 0.0


class DeadlineExecutor:
    def __init__(self, deadline_s: float, max_workers: Optional[int] = None):
        self.deadline_s = deadline_s
        self.max_workers = max_workers

    def run(self, fns: Sequence[Callable[[], object]]) -> list:
        """Run the stream computations concurrently and mark a deadline
        miss failed. At most ONE failure is reported (the single fail-stop
        model): if several streams miss the deadline, one of them is marked
        failed and the others are awaited."""
        results = [StreamResult(i) for i in range(len(fns))]
        start = time.monotonic()
        with cf.ThreadPoolExecutor(
                max_workers=self.max_workers or len(fns)) as ex:
            futs = {ex.submit(fn): i for i, fn in enumerate(fns)}
            done, pending = cf.wait(
                set(futs),
                timeout=max(start + self.deadline_s - time.monotonic(), 0))
            for f in done:
                i = futs[f]
                results[i].value = f.result()
                results[i].elapsed_s = time.monotonic() - start
            if pending:
                slowest = next(iter(pending))
                for f in pending:
                    if f is not slowest:
                        i = futs[f]
                        results[i].value = f.result()
                        results[i].elapsed_s = time.monotonic() - start
                results[futs[slowest]].failed = True
                slowest.cancel()
        return results

    @staticmethod
    def failed_index(results: list) -> Optional[int]:
        for r in results:
            if r.failed:
                return r.index
        return None
