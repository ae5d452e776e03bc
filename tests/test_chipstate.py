"""Timing utilities and the persistent compile cache."""

import time

import jax

from pplp_tpu.utils import chipstate


def test_timed_windows_measures_and_bounds_budget():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    x = jax.numpy.arange(8)
    t0 = time.perf_counter()
    best, med = chipstate.timed_windows(
        fn, x, windows=3, inner=2, gap_s=0.0, budget_s=5.0
    )
    assert 0 <= best <= med
    assert time.perf_counter() - t0 < 10.0
    assert len(calls) >= 7  # 1 warmup + 3 windows x 2 inner


def test_timed_windows_records_at_least_one_window_when_gated_out():
    # A budget already spent cuts the window loop, but never below one
    # window: the loop must record it rather than hang or return empty.
    calls = []

    def fn(x):
        calls.append(1)
        return x

    best, med = chipstate.timed_windows(
        fn, jax.numpy.arange(4), windows=4, inner=1, gap_s=0.0, budget_s=-1.0
    )
    assert best > 0 and med > 0
    assert len(calls) == 2  # 1 warmup + exactly 1 window


def test_timed_windows_multi_interleaves_all_variants():
    calls = {"a": 0, "b": 0}

    def mk(name):
        def fn(x):
            calls[name] += 1
            return x * 2
        return fn

    x = jax.numpy.arange(8)
    out = chipstate.timed_windows_multi(
        {"a": (mk("a"), (x,)), "b": (mk("b"), (x,))},
        windows=3, inner=2, gap_s=0.0, budget_s=5.0,
    )
    assert set(out) == {"a", "b"}
    for best, med in out.values():
        assert 0 <= best <= med
    # Both variants sampled the same number of measurement rounds.
    assert calls["a"] == calls["b"] >= 7  # warmup + 3 windows x 2


def test_timed_windows_multi_never_healthy_falls_back_ungated():
    # Spent budget: every variant still gets exactly one window.
    calls = {"a": 0, "b": 0}

    def mk(name):
        def fn(x):
            calls[name] += 1
            return x + 1
        return fn

    x = jax.numpy.arange(4)
    out = chipstate.timed_windows_multi(
        {"a": (mk("a"), (x,)), "b": (mk("b"), (x,))},
        windows=3, inner=1, gap_s=0.0, budget_s=-1.0,
    )
    for best, med in out.values():
        assert best > 0 and med > 0
    assert calls == {"a": 2, "b": 2}  # warmup + one window each


def test_enable_compile_cache_idempotent():
    chipstate.enable_compile_cache()
    chipstate.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir is not None
