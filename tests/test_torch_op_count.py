"""``scripts/torch_op_count.py``: the operations one serving decode step
issues, counted on the CPU at reduced width (the card is its default)."""
import importlib.util
import pathlib

import pytest
import torch

_PATH = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
    "torch_op_count.py"


def _script():
    spec = importlib.util.spec_from_file_location("torch_op_count", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["hymba_1_5b", "qwen3_32b"])
def test_decode_operations_grow_by_a_fixed_count_a_layer(arch):
    """The count of a step is the same function of depth at 2, 4 and 6
    layers: a fixed cost a layer and one outside; the plain versions
    launch no kernel."""
    op = _script()
    counts = [op.decode_ops(arch, n, "cpu", reduced=True) for n in (2, 4, 6)]
    (a, ka), (b, kb), (c, kc) = counts
    assert b - a == c - b > 0
    assert ka == kb == kc == 0


def test_encoder_decoder_is_refused():
    with pytest.raises(ValueError, match="frames"):
        _script().decode_ops("seamless_m4t_medium", 2, "cpu", reduced=True)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_card_is_the_default_and_raises_without_one():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script().main(["hymba_1_5b"])
