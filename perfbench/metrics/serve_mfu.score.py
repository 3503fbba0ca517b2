"""Model step (``models/transformer.py``, ``rwkv.py``, ``mamba.py``,
``attention.py``): the model's counted operations (``counts/model.py``)
for the traced cycle's batches over the time in which any device
operation of that cycle ran, a share in % of the H100's bfloat16 peak."""
from perfbench.counts import model, peaks


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.device_s <= 0:
        return None
    B = int(ctx.mix["batch"])
    flops = sum(model.batch_flops(ctx.model, L, B) for L in tr.lengths)
    return 100.0 * flops / tr.device_s / peaks.BF16_FLOPS
