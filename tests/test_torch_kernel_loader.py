"""The port's kernel registry (``metrics_tpu_torch/ops/kernels/__init__.py``),
on a host without ``nvcc``. Nothing here compiles or loads a kernel."""
from metrics_tpu_torch.ops import kernels as kernels_mod
from metrics_tpu_torch.ops.kernels import CSRC_DIR, KERNELS


def test_registry_names_sources_and_counters():
    assert all(name == kernel.name for name, kernel in KERNELS.items())
    assert all((CSRC_DIR / kernel.source).is_file() for kernel in KERNELS.values())
    # one library per source; an entry that shares another's library (B1's
    # tenant-batched launch) names a kernel of the same source
    owners = [kernel for kernel in KERNELS.values() if kernel.shares is None]
    assert len({kernel.source for kernel in owners}) == len(owners)
    assert all(KERNELS[k.shares].shares is None and KERNELS[k.shares].source == k.source
               for k in KERNELS.values() if k.shares is not None)
    assert len({kernel.library_path() for kernel in KERNELS.values()}) == len(KERNELS)
    assert KERNELS["maxsim_tf32x3"].source == "maxsim_tc.cu"
    assert set(kernels_mod.launch_counts()) == set(KERNELS)
