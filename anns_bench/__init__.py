"""The benchmark of prefhetch_tpu_torch: one run of one cell is
``python3 -m anns_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
"""
