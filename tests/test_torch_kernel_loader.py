"""The port's kernel registry (``metrics_tpu_torch/ops/kernels/__init__.py``),
on a host without ``nvcc``. Nothing here compiles or loads a kernel."""
from metrics_tpu_torch.ops import kernels as kernels_mod
from metrics_tpu_torch.ops.kernels import CSRC_DIR, KERNELS


def test_registry_names_sources_and_counters():
    assert all(name == kernel.name for name, kernel in KERNELS.items())
    assert all((CSRC_DIR / kernel.source).is_file() for kernel in KERNELS.values())
    assert len({kernel.source for kernel in KERNELS.values()}) == len(KERNELS)
    assert len({kernel.library_path() for kernel in KERNELS.values()}) == len(KERNELS)
    assert KERNELS["maxsim_tf32x3"].source == "maxsim_tc.cu"
    assert set(kernels_mod.launch_counts()) == set(KERNELS)
