"""The benchmark of `repro_torch`, REFT's PyTorch and CUDA port.

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on the card and prints
one JSON line. Everything the harness needs by name sits in files of its
own: a configuration in `configs/<name>.json`, a cell in
`workloads/<name>.json`, its traffic in `traffic/<name>.json`, a metric's
reader in `metrics/<name>.py`. The yardstick (weights and batches from
the seed, the plain fp32 reference, the peaks, the FLOP and byte
formulas, the comparison that decides `correct`) lives here and imports
nothing of the program; the program gives only the system under test,
its counters and its kernel names.
"""
