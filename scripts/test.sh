#!/bin/bash
# Dual-precision CI sweep (cf. the reference's FLOATX sweep,
# reference scripts/test.sh:9): the whole suite runs at float32 (the
# default width) and again at float64 (jax_enable_x64 wired by
# pymc3_tpu.config._apply_floatX).
set -e
cd "$(dirname "$0")/.."
# RuntimeWarnings are errors: a clean suite must not mask
# real numeric warnings (divide-by-zero, overflow) behind green dots
echo "=== float32 ==="
PYMC3_TPU_FLOATX=float32 python -m pytest tests/ -q -W "error::RuntimeWarning" "$@"
echo "=== float64 ==="
PYMC3_TPU_FLOATX=float64 python -m pytest tests/ -q -W "error::RuntimeWarning" "$@"
