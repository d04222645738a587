"""The benchmark of the PyTorch/CUDA port (``stereoreconstruction_tpu_torch``):

    python3 -m portbench.run --workload <cell> --seed N --seconds S \
        --trace 0|1
"""
