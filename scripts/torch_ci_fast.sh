#!/usr/bin/env bash
# Fast test run of the PyTorch/CUDA port (src/repro_torch) on a CPU host,
# the port's counterpart of scripts/ci_fast.sh: fully offline, slow tests
# and the tests that need a card excluded.
#
#   scripts/torch_ci_fast.sh [extra pytest arguments]
#
# The parity tests compare the port with the JAX package, on JAX's CPU
# backend.  The reference's five `benchmarks.* --smoke` gates have no
# counterpart here yet: they wait for the port's benchmark harness
# (ROADMAP A8).
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"
# Lint first, as the reference's guard does (ruff.toml); hosts without
# ruff fall through so the test tiers still run offline.
if command -v ruff >/dev/null 2>&1; then
  ruff check .
else
  echo "[torch_ci_fast] ruff not installed; lint enforced by CI only"
fi
# Access-mode lint: every registered GrFunction's declared const/out/inout
# modes checked against its traced graph, the port's examples' included.
# Exit 1 on any under-/over-declaration.
python -m repro_torch.analysis lint \
  --file examples/torch_quickstart.py \
  --file examples/torch_serve_lm.py \
  --file examples/torch_train_lm.py
# Capture/replay first: a focused signal before the full sweep (these also
# run as part of the sweep below).
python -m pytest -q tests/test_torch_core_capture.py
# Multi-tenant QoS and deadline/SLO scheduling.
python -m pytest -q tests/test_torch_core_multitenant.py \
  tests/test_torch_core_slo.py
exec python -m pytest -q -m "not slow and not cuda" tests/test_torch_*.py "$@"
