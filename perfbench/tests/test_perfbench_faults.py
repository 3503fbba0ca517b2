"""A run whose timed path is broken underneath comes out not correct: the
harness's whole run on the CPU (its look for a card skipped), with the
program patched where it produces a token, a batch or a state.

The cells run at their published width with two layers (``wide_cell``):
at the tiny width the embedding alone sets the served token, and a
recurrence that keeps no state would move nothing.  The limit, 0.04, lies
above the sound runs (widest gap 0 to 0.016 on seeds 1 to 3) and far
below the faults (4.39 to 5.26 on seed 2)."""
import pytest
import torch

from conftest import BENCH, wide_cell
from perfbench import harness

LIMIT = 0.04
CELLS = [w["name"] for w in BENCH["workloads"]]


def _prefill_wrapper(monkeypatch, change):
    import repro_torch.runtime.serving as serving
    make = serving.make_prefill_step

    def patched(cfg, use_flash=False):
        step = make(cfg, use_flash)

        def prefill(params, batch, cache):
            logits, cache = step(params, batch, cache)
            return change(logits), cache
        return prefill
    monkeypatch.setattr(serving, "make_prefill_step", patched)


def token_altered(monkeypatch, cell):
    """Each served token is the one after the model's choice."""
    _prefill_wrapper(monkeypatch, lambda lg: lg.roll(1, dims=-1))


def half_batch_left_out(monkeypatch, cell):
    """The second half of each batch is never computed: its logits stay
    zero."""
    def drop(lg):
        lg = lg.clone()
        lg[lg.shape[0] // 2:] = 0
        return lg
    _prefill_wrapper(monkeypatch, drop)


def state_unchanged(monkeypatch, cell):
    """The recurrence never carries its state from one step to the next:
    WKV6 keeps only each token's own bonus term."""
    import repro_torch.models.rwkv as R

    def wkv6(r, k, v, w, u, s0):
        B, T, H, hd = r.shape
        y = (r.float() * u.float() * k.float()).sum(-1, keepdim=True) \
            * v.float()
        return y.to(r.dtype).reshape(B, T, H * hd), s0
    monkeypatch.setattr(R, "wkv6", wkv6)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, seed):
    torch.set_num_threads(4)
    res = harness.run_cell(wide_cell(name, LIMIT), seed, 0.0, False,
                           device="cpu")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 28


@pytest.mark.parametrize("fault", [token_altered, half_batch_left_out,
                                   state_unchanged],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_broken_run_is_not_correct(name, fault, monkeypatch):
    torch.set_num_threads(4)
    cell = wide_cell(name, LIMIT)
    fault(monkeypatch, cell)
    res = harness.run_cell(cell, 2, 0.0, False, device="cpu")
    assert not res["correct"]
    assert res["checks"]["logit_gap"]["value"] > LIMIT


def test_missing_answer_is_failed(monkeypatch):
    """A request that never gets its answer counts as failed."""
    import repro_torch.runtime.serving as serving
    collect = serving.ServingEngine.collect

    def lossy(self):
        done = collect(self)
        done[-1].result = None
        return done
    monkeypatch.setattr(serving.ServingEngine, "collect", lossy)
    from conftest import tiny_cell
    res = harness.run_cell(tiny_cell(CELLS[0], limit=1.0), 1, 0.0, False,
                           device="cpu")
    assert res["failed"] == 7 and not res["correct"]
