"""The benchmark of the PyTorch and CUDA port (``one2345_tpu_torch``) on
NVIDIA H100 cards: ``python portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  ``BENCHMARK.json`` at the checkout's root
lists the cells, configurations and metrics; ``harness.py`` says which
files each is made of."""
