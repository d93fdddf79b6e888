"""Async reader/writer lock for the endorsement-vs-commit seam
(counterpart: ``fabric_tpu/utils/locks.py``).

The reference's transaction manager takes a SHARED lock for simulation
and an exclusive one for the committer
(core/ledger/kvledger/txmgmt/txmgr/lockbased_txmgr.go; endorser.go:379)
— so client endorsements proceed in parallel with each other and only
serialize against block commits.  Write-preferring: a waiting committer
blocks NEW readers, so a stream of endorsements cannot starve the
commit pipeline."""

from __future__ import annotations

import asyncio
from contextlib import asynccontextmanager


class AsyncRWLock:
    def __init__(self):
        self._readers = 0
        self._writer_active = False
        self._writers_waiting = 0
        self._cond: asyncio.Condition | None = None

    def _c(self) -> asyncio.Condition:
        # lazily bound to the running loop (nodes are constructed
        # before their event loop starts in some tests)
        if self._cond is None:
            self._cond = asyncio.Condition()
        return self._cond

    @asynccontextmanager
    async def reader(self):
        cond = self._c()
        async with cond:
            await cond.wait_for(lambda: not self._writer_active and not self._writers_waiting)
            self._readers += 1
        try:
            yield
        finally:
            async with cond:
                self._readers -= 1
                cond.notify_all()

    @asynccontextmanager
    async def writer(self):
        cond = self._c()
        async with cond:
            self._writers_waiting += 1
            try:
                await cond.wait_for(lambda: not self._writer_active and self._readers == 0)
                self._writer_active = True
            finally:
                self._writers_waiting -= 1
        try:
            yield
        finally:
            async with cond:
                self._writer_active = False
                cond.notify_all()
