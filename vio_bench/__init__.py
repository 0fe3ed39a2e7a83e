"""The benchmark of the PyTorch and CUDA port (orcvio_tpu_torch): many
VIO streams and a fleet back end on one H100. Run a cell with
``python3 vio_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; BENCHMARK.json lists the
cells."""
