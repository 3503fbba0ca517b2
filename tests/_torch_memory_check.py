"""The memory-accounting check of ``tests/conftest.py`` for the port's
scheduler: test modules of the port import this fixture, which reconciles
``repro_torch``'s MemoryManager ledger at every ``sync`` of a simulated
scheduler, so drift fails at the sync that caused it."""
import pytest


@pytest.fixture(autouse=True)
def _verify_torch_memory_accounting(monkeypatch):
    from repro_torch.core.scheduler import GrScheduler

    orig_sync = GrScheduler.sync

    def sync_and_verify(self, *a, **kw):
        res = orig_sync(self, *a, **kw)
        if type(self.executor).__name__ == "SimExecutor":
            report = self.memory.verify(raise_on_drift=False)
            assert report.ok, f"memory accounting drift at sync: {report}"
        return res

    monkeypatch.setattr(GrScheduler, "sync", sync_and_verify)
