"""bench.py's _guard: a failing profile point is recorded once, with no
retry, so one error cannot kill the whole bench line or be run twice."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402


@pytest.mark.parametrize("exc", [
    RuntimeError("INTERNAL: CUDA error: an illegal memory access"),
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 4.2 GiB"),
    ValueError("energy gate failed"),
], ids=["internal", "resource-exhausted", "value-error"])
def test_guard_does_not_retry_real_errors(exc):
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise exc

    out = bench._guard(broken)
    assert out["ok"] is False
    assert str(exc) in out["error"]
    assert type(exc).__name__ in out["error"]
    assert calls["n"] == 1
