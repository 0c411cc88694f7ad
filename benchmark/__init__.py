"""The benchmark of the PyTorch and CUDA port (``image_segmentation_tpu_torch``).

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1
"""
