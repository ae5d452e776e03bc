"""Dispatch-amortized timing helpers and the persistent compile cache.

* :func:`timed_windows` / :func:`timed_windows_multi` — best and median
  seconds per call over spaced windows. JAX dispatch is asynchronous, so each
  window queues ``inner`` back-to-back calls and waits once at the end; with
  ``inner=None`` the count is sized for ~0.25 s of queued work, which
  amortizes the fixed cost of one synchronous dispatch.
* :func:`timed_chain_slope` — per-call time from the slope between two
  lengths of a chain of calls ended by a host fetch, for single-op graphs
  whose per-call time is small against one dispatch.
* :func:`measure_stream_peak_gbps` — the streaming bandwidth this device
  reaches on plain copies, the bound a memory-bound transform is compared with.
* :func:`enable_compile_cache` — JAX's persistent compilation cache, so
  every process of one checkout reuses compiled stages.
* :func:`gpu_name_and_power_limit` — the card's name and power limit as
  ``nvidia-smi`` reports them, printed beside every device number.

The reference has no analogue (single local CPU, `chrono` timers around
stages, ``include/benchmark.h:71-74``).
"""

from __future__ import annotations

import os
import subprocess
import time

import jax
import jax.numpy as jnp

# <checkout>/.jax_cache: fixed, inside the checkout, listed in .gitignore.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself);
    otherwise the cache lives at :data:`DEFAULT_CACHE_DIR`."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``. A card may run below its maximum
    power, and then slower under load, so this goes beside every number."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def _calibrate_inner(per_call_s: float, target_s: float = 0.25,
                     max_inner: int = 256) -> int:
    return max(1, min(max_inner, round(target_s / max(per_call_s, 1e-5))))


def timed_windows_multi(
    fns: dict,
    windows: int = 8,
    inner: int | None = None,
    gap_s: float = 0.25,
    budget_s: float = 150.0,
):
    """Round-robin timing of several variants: {name: (fn, args)}.

    Interleaving means every variant samples the same state of the machine
    (clocks, host load), so a slow stretch cannot crown a "winner" by
    landing on the loser's turn.

    ``inner=None`` auto-sizes the back-to-back call count per variant so
    each window queues ~0.25 s of device work: async dispatches pipeline, so
    this amortizes the fixed cost of one synchronous dispatch.
    Returns {name: (best, median)} seconds/call.
    """
    # Budget clock starts BEFORE warmup/calibration so a slow variant set
    # cannot overrun the caller's wall-budget slice: the window loop still
    # guarantees >=1 window per variant once reached.
    t_start = time.perf_counter()
    for fn, args in fns.values():  # warmup/compile
        jax.block_until_ready(fn(*args))
    inners = {}
    for name, (fn, args) in fns.items():
        if inner is not None:
            inners[name] = inner
            continue
        t0 = time.perf_counter()
        out = None
        for _ in range(4):
            out = fn(*args)
        jax.block_until_ready(out)
        inners[name] = _calibrate_inner((time.perf_counter() - t0) / 4)
    times = {name: [] for name in fns}
    rounds = 0
    while rounds < windows:
        if time.perf_counter() - t_start > budget_s and all(
            times[n] for n in times
        ):
            break
        for name, (fn, args) in fns.items():
            k = inners[name]
            t0 = time.perf_counter()
            out = None
            for _ in range(k):
                out = fn(*args)
            jax.block_until_ready(out)
            times[name].append((time.perf_counter() - t0) / k)
        rounds += 1
        time.sleep(gap_s)
    out = {}
    for name, ts in times.items():
        ts.sort()
        out[name] = (ts[0], ts[len(ts) // 2])
    return out


def timed_chain_slope(fn, x0, inners=(16, 64), reps=5, gap_s=0.25, extra=()):
    """(best, median) per-call seconds via the fetch-barrier slope method.

      * chain calls (z = fn(z, *extra)) so no dispatch can be elided,
      * end each timed window by fetching a scalar derived from the final
        buffer (device->host data cannot arrive before it exists),
      * take the slope of wall time between two chain lengths, cancelling
        the constant dispatch and fetch overhead of a window.

    Requires fn's output to be a valid input (same shape/dtype/domain)."""
    probe = jax.jit(lambda a: a.ravel()[:8].astype(jnp.uint32).sum())
    z = fn(x0, *extra)
    int(probe(z))  # warm both executables
    slopes = []
    for _ in range(reps):
        ts = {}
        for n in inners:
            z = x0
            t0 = time.perf_counter()
            for _ in range(n):
                z = fn(z, *extra)
            int(probe(z))
            ts[n] = time.perf_counter() - t0
        slopes.append((ts[inners[1]] - ts[inners[0]]) / (inners[1] - inners[0]))
        time.sleep(gap_s)
    slopes.sort()
    return slopes[0], slopes[len(slopes) // 2]


def measure_stream_peak_gbps(mib: int = 256, reps: int = 3) -> tuple[float, float]:
    """Measured streaming speed-of-light (GB/s): best of chained copyadd
    (1R+1W) and saxpy (2R+1W) at ``mib`` working set, fetch-barrier slope.
    Returns (best, median_of_best_kernel)."""
    elems = mib * (1 << 20) // 4
    x = jnp.arange(elems, dtype=jnp.uint32).reshape(-1, 1024)
    copyadd = jax.jit(lambda a: a + jnp.uint32(1))
    saxpy = jax.jit(lambda a, b: a * jnp.uint32(3) + b)
    best = (0.0, 0.0)
    for fn, nbytes, extra, inners in (
        (copyadd, 2 * 4 * elems, (), (32, 128)),
        (saxpy, 3 * 4 * elems, (x,), (32, 96)),
    ):
        b, m = timed_chain_slope(fn, x, inners=inners, reps=reps, extra=extra)
        if nbytes / b / 1e9 > best[0]:
            best = (nbytes / b / 1e9, nbytes / m / 1e9)
    return best


def timed_windows(
    fn,
    *args,
    windows: int = 10,
    inner: int | None = None,
    gap_s: float = 0.25,
    budget_s: float = 90.0,
):
    """(best, median) seconds/call over spaced measurement windows.

    ``inner=None`` auto-amortizes the per-dispatch cost (see
    :func:`timed_windows_multi`); at least one window is always recorded,
    however small ``budget_s``.
    """
    out = fn(*args)
    jax.block_until_ready(out)
    if inner is None:
        t0 = time.perf_counter()
        for _ in range(4):
            out = fn(*args)
        jax.block_until_ready(out)
        inner = _calibrate_inner((time.perf_counter() - t0) / 4)
    times = []
    t_start = time.perf_counter()
    for _ in range(windows):
        if time.perf_counter() - t_start > budget_s and times:
            break
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / inner)
        time.sleep(gap_s)
    times.sort()
    return times[0], times[len(times) // 2]
