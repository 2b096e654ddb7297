__version__ = "0.1.0"
__author__ = "metrics_tpu contributors"
__license__ = "Apache-2.0"
__docs__ = "PyTorch/CUDA port of metrics_tpu (hand-written CUDA kernels for Hopper)"
