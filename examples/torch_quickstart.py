"""Quickstart on the PyTorch/CUDA port: the polyglot frontend in 30 lines.

Declare each kernel ONCE with its access modes (`gr.function`), enter an
ambient runtime, and write plain sequential host code: the runtime infers
the dependency DAG, assigns lanes (CUDA streams), inserts events, prefetches
host-resident inputs, allocates declared outputs, and overlaps everything
it can: the paper's programming model (Fig. 4), with PyTorch kernels.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Without a CUDA device and without ``--device cpu`` it raises.  Importing
this file runs nothing (``python -m repro_torch.analysis lint --file``
imports it to check the declarations).
"""
import argparse

import numpy as np

import repro_torch.api as gr

# Declare once: access modes, output specs, never re-annotated at calls.
square = gr.function(lambda x, _out: x * x,
                     modes=("const", "out"), outputs=0, name="square")
reduce_diff = gr.function(lambda a, b, _out: (a - b).sum()[None],
                          modes=("const", "const", "out"),
                          outputs=((1,), np.float32), name="RED")


def main(argv=None):
    """Runs the two squares and their reduction; returns z and the number
    of lanes the kernels ran on."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the lanes run: cuda (one stream a lane) or "
                         "cpu")
    args = ap.parse_args(argv)

    with gr.runtime(policy="parallel", device=args.device) as sched:
        # managed arrays (the UM-backed polyglot arrays of the paper)
        x1 = gr.array(np.random.rand(1 << 16).astype(np.float32), name="x1")
        x2 = gr.array(np.random.rand(1 << 16).astype(np.float32), name="x2")

        # Plain function calls: the scheduler runs the two squares on
        # separate lanes, prefetches x1/x2 asynchronously, serializes RED
        # behind both, and allocates y1/y2/z from the declared output specs.
        y1 = square(x1)
        y2 = square(x2)
        z = reduce_diff(y1, y2)

        zval = float(z[0])                  # host read: syncs RED's lane
        print("z =", zval)
        print("scheduler stats:", sched.stats())
        assert np.isclose(zval,
                          float((np.asarray(y1) - np.asarray(y2)).sum()),
                          rtol=1e-4)
        kernels = [e for e in sched._elements if e.kind.value == "kernel"]
        lanes = len({e.stream for e in kernels})
        print("OK: two branches ran on", lanes, "lanes")
        sched.shutdown()
    return zval, lanes


if __name__ == "__main__":
    main()
