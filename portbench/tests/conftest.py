"""The benchmark's own tests (``python -m pytest portbench/tests``).  Tests
marked ``cuda`` need the card and skip elsewhere, deciding inside the
test."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips when torch.cuda.is_available() is false")
