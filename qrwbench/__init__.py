"""The benchmark of qrw_tpu_torch, the PyTorch and CUDA port of qrw_tpu.

    python3 -m qrwbench.run --workload NAME --seed N --seconds S --trace 0|1

`BENCHMARK.json` at the root names the cells. Each cell's configuration
lives in `configs/<name>.json`, its traffic mix in `traffic/<name>.json`
(read by one of the general drivers in `drivers/`), and each per-layer
metric in `metrics/<name>.py`. The plain references that decide
`correct` are in `reference/`: they import neither JAX nor the JAX
package nor anything of the port.
"""
