"""Registers the marker for tests that need a CUDA card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips "
                   "where torch.cuda.is_available() is false")
