"""Benchmark entry point: one JSON line per metric, for one NVIDIA GPU.

    python bench.py          # needs a GPU; exits non-zero without one

Headline metric (BASELINE.md north star): BFV ciphertext-ciphertext multiplies
per second, n=4096, including relinearization, batched on one card. The
headline goes to stdout; the secondary metrics (DGK comparisons, the packed
proximity pipeline, NTT transforms) go to stderr, one JSON line each.

Every line carries the card's name and power limit (``nvidia-smi``) and JAX's
``device_kind``: a card set below its maximum power runs slower under load,
so a number is only comparable beside them. The multiply is the op-by-op BEHZ
graph with the XLA four-step NTT; the headline interleaves the dual-chain
(2x128) and single-chain (256) forms and takes the best. All key setup runs
under ONE jit (behz.make_keys_jit).

Metric order: multiply (headline) -> DGK -> proximity -> NTT, each inside an
explicit share of the wall budget (PPLP_BENCH_BUDGET_S, default 540 s). A
phase left out for the budget is logged as skipped; a phase that fails
raises, and the exit code is non-zero.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from pplp_tpu.ops import ntt
from pplp_tpu.ops.primes import Modulus, get_primes
from pplp_tpu.utils.chipstate import (
    enable_compile_cache,
    gpu_name_and_power_limit,
    measure_stream_peak_gbps,
    timed_chain_slope,
    timed_windows,
    timed_windows_multi,
)

_DEVICE_FIELDS: dict = {}


def _log(obj, stdout=False):
    print(
        json.dumps({**obj, **_DEVICE_FIELDS}),
        file=sys.stdout if stdout else sys.stderr, flush=True,
    )


def _synthetic_cts(ctx, batch, n):
    import numpy as np

    from pplp_tpu.bfv.ciphertext import Ciphertext

    rng = np.random.default_rng(0)
    qs = np.array([m.value for m in ctx.moduli], np.uint64)[None, :, None]

    def poly():
        v = rng.integers(0, 1 << 62, size=(batch, ctx.L, n)).astype(np.uint64) % qs
        return jnp.asarray(v.astype(np.uint32))

    return Ciphertext((poly(), poly()), "coeff"), Ciphertext((poly(), poly()), "coeff")


def build_multiply_fns(n=4096, batch=256):
    """Production mult+relin variants, all on the op-by-op BEHZ graph with
    the XLA four-step NTT:

      dual_wide — TWO independent 128-batch chains in one jit call (two
                  overlapping chains beat one 256-batch chain on the first
                  accelerator target; not yet compared on the GPU) with the
                  PRODUCTION relinearization (make_keys_jit ->
                  create_relin_keys -> default_relin_width picks the
                  noise-bounded width-2 gadget at these parameters: half
                  the keyswitch NTTs; exactness pinned in
                  tests/test_multiply.py::test_relinearize_wide_gadget)
      dual_b128 — same chains with the classic per-limb gadget (explicit
                  width=1 keys), for the record
      single_b256 — the production single-chain form, for the record
    """
    from pplp_tpu.bfv import BFVContext, EncryptionParameters
    from pplp_tpu.bfv.behz import (
        RnsMultiplier,
        create_relin_keys,
        make_keys_jit,
        relinearize,
    )

    parms = EncryptionParameters.bfv(n, 1 << 16, profile="tpu")
    fns = {}
    ctx = BFVContext.build(parms, engine="four")
    sk, rlk = make_keys_jit(ctx, 0)  # rlk: production gadget width
    mul = RnsMultiplier(ctx)
    mr = lambda a, b: relinearize(ctx, mul.multiply(a, b), rlk).polys
    ct1, ct2 = _synthetic_cts(ctx, batch, n)
    fns["single_b256"] = (jax.jit(mr), (ct1, ct2), batch)
    h = batch // 2
    d1, d2 = _synthetic_cts(ctx, h, n)
    d3, d4 = _synthetic_cts(ctx, h, n)
    rlk_w1 = jax.jit(
        lambda key: create_relin_keys(ctx, sk, key, width=1)
    )(jax.random.key(2))
    mr1 = lambda a, b: relinearize(ctx, mul.multiply(a, b), rlk_w1).polys
    dual1 = jax.jit(lambda a, b, c, d: (mr1(a, b), mr1(c, d)))
    fns["dual_b128"] = (dual1, (d1, d2, d3, d4), batch)
    dual_w = jax.jit(lambda a, b, c, d: (mr(a, b), mr(c, d)))
    fns["dual_wide"] = (dual_w, (d1, d2, d3, d4), batch)
    return fns


def measure_multiply(fns, budget_s=120.0):
    """Interleaved amortized windows -> (best value, {path: (best, median)})."""
    timed = timed_windows_multi(
        {k: (f, a) for k, (f, a, _) in fns.items()},
        windows=8, budget_s=budget_s,
    )
    results = {
        k: (fns[k][2] / b, fns[k][2] / m) for k, (b, m) in timed.items()
    }
    winner = max(results, key=lambda k: results[k][0])
    _log(
        {
            "multiply_paths": {
                k: {"best": v[0], "median": v[1]} for k, v in results.items()
            },
            "winner": winner,
        }
    )
    return results[winner][0], results


def bench_dgk(batch=10000, k=2048, t=320, l=16, budget_s=60.0):
    """10k-wide DGK homomorphic comparisons (BASELINE config[2])."""
    import random

    from pplp_tpu.dgk import dgk_gen_keys
    from pplp_tpu.dgk.batched import DGKBatch
    from pplp_tpu.dgk.dgk import dgk_random_num

    priv, pub = dgk_gen_keys(k, t, l, seed=5, init_table=False)
    dbatch = DGKBatch.build(pub)
    rng = random.Random(0)
    ms = [rng.randrange(0, pub.u) for _ in range(batch)]
    rs = [dgk_random_num(int(2.5 * t), rng) for _ in range(batch)]
    cts = dbatch.encrypt_batch(ms, rs)
    f = jax.jit(
        lambda a, b, c: dbatch.blind_distance_batch(a, b, c, 123321, 123654, 37, cts, cts)
    )
    best, _ = timed_windows(f, cts, cts, cts, windows=6, budget_s=budget_s)
    return batch / best


def bench_proximity_pipeline(n=4096, rows=25, budget_s=60.0):
    """100k packed encrypted distance+radius checks WITH BF membership
    (BASELINE config[3] verbatim): rows x n coefficients, server homo eval +
    device BEHZ decode + blinded-key formation + Bloom probe — the full
    protocol tail (`/root/reference/src/demo.cc:154-177`). Returns
    (total_checks, best_s, median_s)."""
    import numpy as np

    from pplp_tpu.bfv import BFVContext, EncryptionParameters
    from pplp_tpu.bfv.encryptor import Encryptor
    from pplp_tpu.bfv.keys import make_sk_pk_jit
    from pplp_tpu.parallel.pipeline import (
        build_packed_pipeline_bf,
        make_packed_inputs,
    )
    from pplp_tpu.primitives.bloom import BloomFilter, BloomParameters

    t = 1 << 20
    s_blind, r_blind, w = 501, 99, 0xA5A5
    w_len = w.bit_length()
    parms = EncryptionParameters.bfv(n, t, profile="tpu")
    ctx = BFVContext.build(parms, engine="four")
    # ONE jitted graph each for keys and the three encryptions (eager setup
    # is hundreds of separate dispatches).
    sk, pk = make_sk_pk_jit(ctx, 0)
    enc = Encryptor(ctx, pk)

    # Server-side filter: keys s*(di+r) reduced mod t (the sound reduction —
    # SURVEY §4 modulus-mismatch note), packed (bd << w_len) | w.
    bp = BloomParameters(
        projected_element_count=r_blind * r_blind,
        false_positive_probability=1e-4,
        random_seed=0xA5A5A5A5,
        index_mode="mixed",
    )
    bp.compute_optimal_parameters()
    bf = BloomFilter(bp)
    di = np.arange(r_blind * r_blind, dtype=np.uint64)
    bd_ins = (np.uint64(s_blind) * (di + np.uint64(r_blind))) % np.uint64(t)
    keys = (bd_ins << np.uint64(w_len)) | np.uint64(w)
    bf.insert_u64_batch(
        (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (keys >> np.uint64(32)).astype(np.uint32),
    )

    fn = jax.jit(
        build_packed_pipeline_bf(ctx, sk, 1000, 900, s_blind, r_blind, w, w_len)
    )
    bits, salts = bf._bits_device(), bf._salts_device()
    ts = jnp.uint32(bf.table_size)

    total = rows * n  # 102400 checks
    rng = np.random.default_rng(0)
    xa = rng.integers(0, 1 << 20, total).astype(np.uint64)
    ya = rng.integers(0, 1 << 20, total).astype(np.uint64)
    c1, c2, c3 = make_packed_inputs(ctx, enc, xa, ya, jax.random.key(1))
    best, med = timed_windows(
        fn, c1, c2, c3, bits, salts, ts, windows=8, budget_s=budget_s
    )
    return total, best, med


def bench_ntt(n=8192, n_limbs=3, batch=10240, budget_s=60.0):
    """NTT transforms/s at the BASELINE-named batch (>=10k rows), measured
    with the fetch-barrier slope method (chipstate.timed_chain_slope).

    Returns (best/s, median/s, roofline dict). The roofline share is
    min_sweeps / sweeps_equiv, where sweeps_equiv is the measured time
    expressed in full-array memory passes at the streaming peak MEASURED on
    this device, and min_sweeps=2 is the one-read-one-write lower bound of a
    perfectly fused transform kernel."""
    reps = 4 if budget_s >= 40 else 2
    peak_gbps, _ = measure_stream_peak_gbps(reps=min(reps, 3))
    moduli = [Modulus(q) for q in get_primes(30, n_limbs, n)]
    best = None
    for engine in ("four", "four4"):
        tb = ntt.build_tables(moduli, n, engine=engine)
        q = tb.q[:, None]
        bits = jax.random.bits(jax.random.key(0), (batch, n_limbs, n), jnp.uint32)
        x = bits % q  # mild bias irrelevant for benchmarking
        # Chunked big-batch form: lax.map over 1024-row blocks in ONE jit
        # call (ops/ntt.forward_chunked).
        fwd = jax.jit(lambda v, _tb=tb: ntt.forward_chunked(v, _tb))
        b, m = timed_chain_slope(fwd, x, inners=(4, 12), reps=reps)
        if best is None or b < best[1]:
            best = (engine, b, m)
    engine, b, m = best
    array_bytes = 4 * batch * n_limbs * n
    sweeps = b * peak_gbps * 1e9 / array_bytes
    roofline = {
        "engine": engine,
        "measured_peak_gbps": peak_gbps,
        "sweeps_equiv_at_peak": sweeps,
        "min_sweeps": 2,
    }
    return batch * n_limbs / b, batch * n_limbs / m, roofline


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    enable_compile_cache()
    _DEVICE_FIELDS.update(
        card=gpu_name_and_power_limit(), device_kind=dev.device_kind
    )
    budget_s = float(os.environ.get("PPLP_BENCH_BUDGET_S", "540"))
    t_start = time.perf_counter()

    def remaining():
        return budget_s - (time.perf_counter() - t_start)

    def elapsed():
        return time.perf_counter() - t_start

    # Headline FIRST so a time-capped run still reports it.
    mult_fns = build_multiply_fns()
    value, _ = measure_multiply(
        mult_fns, budget_s=min(110.0, max(45.0, remaining() - 220.0))
    )
    _log(
        {
            "metric": "bfv_ct_mult_relin_per_s_n4096",
            "value": value,
            "unit": "mults/s",
        },
        stdout=True,
    )
    _log({"phase": "multiply_done", "t_elapsed_s": elapsed()})

    if remaining() > 40 and os.environ.get("PPLP_BENCH_DGK") != "0":
        rate = bench_dgk(budget_s=min(60.0, max(20.0, remaining() - 15)))
        _log(
            {
                "metric": "dgk_comparisons_per_s_k2048",
                "value": rate,
                "unit": "comparisons/s",
                "t_elapsed_s": elapsed(),
            }
        )
    else:
        _log({"skipped": "dgk", "reason": "bench time budget"})

    if remaining() > 60:
        checks, secs, med = bench_proximity_pipeline(
            budget_s=min(60.0, max(20.0, remaining() - 15))
        )
        _log(
            {
                "metric": "proximity_checks_per_s_packed_n4096",
                "value": checks / secs,
                "median": checks / med,
                "unit": "checks/s",
                "includes_bf_probe": True,
                "batch_checks": checks,
                "batch_latency_ms": secs * 1e3,
                "t_elapsed_s": elapsed(),
            }
        )
    else:
        _log({"skipped": "proximity_pipeline", "reason": "bench time budget"})

    if remaining() > 40:
        ntt_rate, ntt_med, roofline = bench_ntt(
            budget_s=min(60.0, max(20.0, remaining() - 15))
        )
        _log(
            {
                "metric": "ntt_transforms_per_s_n8192_3primes",
                "value": ntt_rate,
                "median": ntt_med,
                "unit": "transforms/s",
                "batch": 10240,
                # Share of the perfectly fused 2-sweep bound at the streaming
                # peak measured on this device.
                "share_of_measured_peak": (
                    roofline["min_sweeps"] / roofline["sweeps_equiv_at_peak"]
                ),
                **roofline,
                "t_elapsed_s": elapsed(),
            }
        )
    else:
        _log({"skipped": "ntt", "reason": "bench time budget"})


if __name__ == "__main__":
    main()
