# Dev recipes (parity with the reference's justfile:1-16)

test:
    python -m pytest tests/ -q

test-fast:
    python -m pytest tests/ -q -x -k "not sharding and not tv"

bench:
    python bench.py

bench-matrix:
    python benchmarks/run_benchmarks.py --dtype float64 --platform cpu

# judge a fresh matrix run against the committed baseline (CI red on
# iteration-count changes or >1.5x median-time regressions)
bench-regression:
    python benchmarks/regression_check.py

# re-record the committed baseline after an intentional behavior change
bench-regression-update:
    python benchmarks/regression_check.py --update

bench-paths:
    python benchmarks/driver_gap.py --repeat 5

bench-tv:
    python benchmarks/tv_bench.py --repeat 5

bench-shared:
    python benchmarks/shared_bench.py

bench-svm:
    python benchmarks/svm_bench.py

bench-cvar:
    python benchmarks/cvar_bench.py

bench-adaptive-flat:
    python benchmarks/flat_ls_bench.py --adaptive

bench-blocking:
    python benchmarks/flat_ls_bench.py --blocking

bench-recording:
    python benchmarks/recording_bench.py

scaling:
    python benchmarks/scaling.py

scaling-cpu:
    python benchmarks/scaling.py --platform cpu

smoke:
    python chip_smoke.py

format:
    python -m ruff format proxtpu tests || true

graft-check:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 python __graft_entry__.py

bench-families:
    python benchmarks/families_bench.py

bench-x64:
    python benchmarks/x64_batched.py

bench-x64-stream:
    python benchmarks/x64_batched.py --stream

bench-x64-restart:
    python benchmarks/x64_batched.py --restart

bench-warm-single:
    python benchmarks/warm_single_bench.py

bench-matrix-completion:
    python benchmarks/matrix_completion_bench.py

bench-glasso:
    python benchmarks/glasso_bench.py

bench-tv1d:
    python benchmarks/tv1d_bench.py --batch 4096 --n 512
