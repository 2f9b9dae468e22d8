from repro_torch.kernels.rglru.ops import rglru  # noqa: F401
