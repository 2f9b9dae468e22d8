# The suite and its measurement harness (the port's part of the paper's
# benchmarking infrastructure so far).
from repro_torch.core.harness import Measurement, RegressionHook, measure  # noqa: F401
from repro_torch.core.suite import Benchmark, Built, build_arch, get_benchmark  # noqa: F401
