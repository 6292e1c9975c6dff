def pytest_configure(config):
    # socket-bearing tests carry @pytest.mark.timeout: a per-test watchdog
    # when pytest-timeout is installed, a registered no-op otherwise (the
    # container image does not ship the plugin)
    config.addinivalue_line(
        "markers",
        "timeout(seconds): per-test watchdog (pytest-timeout plugin)")
    # tests of the port's CUDA kernels: they need an NVIDIA GPU and nvcc and
    # skip elsewhere (tests/test_torch_cuda.py)
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU and nvcc; skipped without one")
