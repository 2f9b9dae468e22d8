from repro_torch.kernels.ssd.ops import ssd  # noqa: F401
