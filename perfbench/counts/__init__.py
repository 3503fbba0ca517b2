"""Frozen counts: the H100's published peaks, each kernel's operations and
bytes a launch, and a model's operations a batch.  They are copies of the
port's own counts (``kernels/*/ops.py``'s ``cost``, ``launch/hlostats.py``),
kept here so that a later change to the program cannot change the
yardstick; ``tests/test_perfbench_counts.py`` holds them to the port's."""
