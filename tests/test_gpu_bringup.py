"""What keeps the GPU path honest, checked on the CPU: the compile-cache
placement, chip_smoke's device refusal and result line, the NTT engine set,
the coefficient-sharding mesh, and the host references chip_smoke compares
the device with."""

import importlib.util
import json
import pathlib
import re

import jax
import numpy as np
import pytest

from pplp_tpu.ops import ntt
from pplp_tpu.ops.primes import Modulus, get_primes, tpu_default
from pplp_tpu.parallel.mesh import factor_devices
from pplp_tpu.utils import chipstate

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert chipstate.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = chipstate.enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_chip_smoke_refuses_cpu_without_rehearse(capsys):
    rc = _chip_smoke().main([])
    out = capsys.readouterr()
    assert rc != 0
    assert "needs a GPU" in out.err
    assert out.out == ""  # no result line, no phase ran


def test_chip_smoke_result_line_contract():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = _chip_smoke().result_line([Dev()])
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }
    assert _chip_smoke().result_line([Dev()] * 4).endswith('"count": 4}}')


def test_build_tables_rejects_removed_engine():
    moduli = [Modulus(q) for q in get_primes(30, 2, 64)]
    with pytest.raises(ValueError, match="unknown NTT engine"):
        ntt.build_tables(moduli, 64, engine="vmem")


def test_no_tpu_kernels_or_platform_branches():
    pattern = re.compile(
        r"pallas\s+import\s+tpu|pallas\.tpu|pltpu|default_backend\(\)"
        r"|platform\s*[!=]=\s*[\"']tpu"
    )
    hits = [
        f"{p.relative_to(ROOT)}:{i}"
        for p in sorted((ROOT / "pplp_tpu").rglob("*.py"))
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if pattern.search(line)
    ]
    assert hits == []


def test_four_and_stage_polymul_agree_n8192_tpu_chain():
    n = 8192
    moduli = [Modulus(q) for q in tpu_default(n)]
    qs = np.array([m.value for m in moduli], np.uint64)[None, :, None]
    rng = np.random.default_rng(3)
    a, b = (
        jax.numpy.asarray(
            (rng.integers(0, 1 << 62, (1, len(moduli), n), dtype=np.uint64) % qs)
            .astype(np.uint32)
        )
        for _ in range(2)
    )
    want = jax.jit(lambda x, y: ntt.negacyclic_polymul(
        x, y, ntt.build_tables(moduli, n, engine="stage")))(a, b)
    got = jax.jit(lambda x, y: ntt.negacyclic_polymul(
        x, y, ntt.build_tables(moduli, n, engine="four")))(a, b)
    assert np.array_equal(np.asarray(want), np.asarray(got))


@pytest.mark.parametrize(
    "n, want",
    [(1, (1, 1, 1)), (2, (1, 1, 2)), (4, (1, 1, 4)), (8, (2, 1, 4)), (16, (2, 2, 4))],
)
def test_factor_devices_shards_coefficients(n, want):
    got = factor_devices(n)
    assert got == want
    assert got[0] * got[1] * got[2] == n


def _schoolbook(a, b, q):
    n = len(a)
    out = [0] * n
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            if i + j < n:
                out[i + j] += int(x) * int(y)
            else:
                out[i + j - n] -= int(x) * int(y)
    return [v % q for v in out]


@pytest.mark.parametrize("q", [(1 << 16), 1073479681, (1 << 44) - 8191])
def test_host_negacyclic_matches_schoolbook(q):
    rng = np.random.default_rng(q & 0xFFFF)
    a = rng.integers(0, q, 64, dtype=np.uint64)
    b = rng.integers(0, q, 64, dtype=np.uint64)
    got = _chip_smoke().host_negacyclic(a, b, q)
    assert got.tolist() == _schoolbook(a, b, q)


def test_numpy_bloom_index_matches_scalar_hash():
    from pplp_tpu.primitives.bloom import BloomFilter, BloomParameters

    bp = BloomParameters(projected_element_count=5000, index_mode="mixed")
    assert bp.compute_optimal_parameters()
    bf = BloomFilter(bp)
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 1 << 63, 64, dtype=np.uint64) * 2 + 1
    klo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    khi = (keys >> np.uint64(32)).astype(np.uint32)
    np_idx = _chip_smoke().np_bloom_indices
    for i, k in enumerate(keys):
        want = list(bf._indices(int(k).to_bytes(8, "little")))
        got = [int(np_idx(klo[i : i + 1], khi[i : i + 1], s, bf.table_size)[0])
               for s in bf.salts]
        assert got == want
